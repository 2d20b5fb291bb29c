"""shard.write_quantize_ms: the program's LAST_STAGES["write_quantize_ms"]
(span mvs.write.quantize inside the write span: the kept pairs' Jaccards
and their 8-bit quantisation), the mean over the window's shards; nothing
where the program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "write_quantize_ms")
