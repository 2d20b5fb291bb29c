"""shard.stage_read_ms: the program's LAST_STAGES["stage_read_ms"] (the wall
of its reads of vectors.bin for staging, summed over the chunks), the mean
over the window's shards; nothing where the program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "stage_read_ms")
