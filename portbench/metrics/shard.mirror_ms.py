"""shard.mirror_ms: the program's LAST_STAGES["mirror_ms"] (spans
mvs.shard.mirror: the selection of the survivors that the host emits again
transposed; their exact filter is shard.finalize_ms), the mean over the
window's shards."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "mirror_ms")
