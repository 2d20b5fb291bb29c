"""shard.entry_host_ms: the benchmark's span around each
compute_pairwise_shard call less the program's LAST_STAGES["total_ms"]
(which starts once the entry has read the db's metadata and ends after the
write): the entry's host work before its timer, the mean over the window's
shards."""


def read(ctx):
    vals = [c["span_ms"] - c["stages"]["total_ms"] for c in ctx.calls
            if c["kind"] == "shard"]
    return sum(vals) / len(vals) if vals else None
