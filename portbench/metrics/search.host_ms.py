"""search.host_ms: LAST_ADAPTIVE_STAGES host_ms + collect_ms (the frontier
bookkeeping, and the final hits' filter, copy and exact recombine) of each
request, the mean over the window's requests."""


def read(ctx):
    vals = [c["stages"]["host_ms"] + c["stages"]["collect_ms"]
            for c in ctx.calls if c["kind"] == "search"]
    return sum(vals) / len(vals) if vals else None
