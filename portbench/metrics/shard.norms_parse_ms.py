"""shard.norms_parse_ms: the program's LAST_STAGES["norms_parse_ms"]
(span mvs.shard.norms_parse: vector_norms.txt parsed, inside the entry),
the mean over the window's shards."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "norms_parse_ms")
