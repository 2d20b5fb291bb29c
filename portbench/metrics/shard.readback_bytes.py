"""shard.readback_bytes: the program's LAST_STAGES["readback_bytes"] (the
bytes the fused engine copies device->host from kernel X: the kept pairs
and its counters), the mean over the window's shards; nothing where the
program has no such counter."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "readback_bytes")
