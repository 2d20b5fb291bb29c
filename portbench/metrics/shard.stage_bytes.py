"""shard.stage_bytes: the program's LAST_STAGES["stage_bytes"] (the bytes of
vectors.bin it read for staging; 0 on a residency hit), the mean over the
window's shards; nothing where the program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "stage_bytes")
