"""shard.stage_ms: the program's LAST_STAGES["stage_ms"] of each shard
(matrix.compute, synchronised stage walls), the mean over the window's
shards."""


def read(ctx):
    vals = [c["stages"]["stage_ms"] for c in ctx.calls if c["kind"] == "shard"]
    return sum(vals) / len(vals) if vals else None
