"""search.outside_adaptive_ms: the benchmark's span around each
search_index request less the program's LAST_ADAPTIVE_STAGES["total_ms"]:
the query parse, the db's norms, the projection and the rescoring, the
mean over the window's requests."""


def read(ctx):
    vals = [c["span_ms"] - c["stages"]["total_ms"] for c in ctx.calls
            if c["kind"] == "search"]
    return sum(vals) / len(vals) if vals else None
