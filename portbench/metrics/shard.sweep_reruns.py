"""shard.sweep_reruns: the program's LAST_STAGES["sweep_reruns"] (the slot
ranges whose kernel APPEND survivors overflowed the sweep's buffer, so that
APPEND swept the range again at its exact count; summed over a shard's
rounds), the mean over the window's shards; nothing where the program has
no such counter."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "sweep_reruns")
