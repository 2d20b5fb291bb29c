"""shard.keep_reruns: the program's LAST_STAGES["keep_reruns"] (the slot
ranges whose kernel X kept more pairs than its buffer holds, so that X ran
again at the exact count; summed over a shard's rounds), the mean over the
window's shards; nothing where the program has no such counter."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "keep_reruns")
