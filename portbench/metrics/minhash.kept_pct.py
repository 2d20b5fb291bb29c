"""minhash.kept_pct: the share of the pairs a MinHash shard tests
(LAST_STAGES["emitted"]: its rows x N) that the retention test keeps and
the writer writes (LAST_STAGES["pairs_written"]), over the window's
shards; nothing where the program has no such counters."""


def read(ctx):
    shards = [c["stages"] for c in ctx.calls if c["kind"] == "shard"
              and "emitted" in c["stages"] and "heavy_ms" in c["stages"]]
    emitted = sum(s["emitted"] for s in shards)
    if not emitted:
        return None
    return 100.0 * sum(s["pairs_written"] for s in shards) / emitted
