"""shard.combine_ms: the program's LAST_STAGES["combine_ms"] (spans
mvs.shard.combine: the host's int64 combine of kernel X's partials of the
sweep's survivors), the mean over the window's shards."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "combine_ms")
