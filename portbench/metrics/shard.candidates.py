"""shard.candidates: LAST_STAGES["candidates"] of each shard, the survivors
of the sweep's float32 test that the host reads back (self-pairs
included), the mean over the window's shards."""


def read(ctx):
    vals = [c["stages"]["candidates"] for c in ctx.calls
            if c["kind"] == "shard"]
    return sum(vals) / len(vals) if vals else None
