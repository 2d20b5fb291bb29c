"""shard.kept_pct: the share of the pairs handed to the exact filter
(LAST_STAGES["emitted"], mirror twins included) that it keeps and the
writer writes (LAST_STAGES["pairs_written"]), over the window's shards."""


def read(ctx):
    shards = [c for c in ctx.calls if c["kind"] == "shard"]
    emitted = sum(c["stages"]["emitted"] for c in shards)
    if not emitted:
        return None
    return 100.0 * sum(c["stages"]["pairs_written"] for c in shards) / emitted
