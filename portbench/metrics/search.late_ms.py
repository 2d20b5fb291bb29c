"""search.late_ms: how late the open loop sent each request, from its due
time to its call (the wait behind the requests before it), the mean over
the window's requests."""


def read(ctx):
    vals = [c["late_ms"] for c in ctx.calls if c["kind"] == "search"]
    return sum(vals) / len(vals) if vals else None
