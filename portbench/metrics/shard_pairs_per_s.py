"""shard_pairs_per_s: ordered pairs decided by the shards completed in the
window, (rows of a shard) x N each, over the window's wall time."""


def read(ctx):
    shards = [c for c in ctx.calls if c["kind"] == "shard"]
    if not shards:
        return None
    return sum(c["rows"] * c["n"] for c in shards) / ctx.window_s
