"""search_queries_per_s: queries answered in the window over its wall
time."""


def read(ctx):
    reqs = [c for c in ctx.calls if c["kind"] == "search"]
    if not reqs:
        return None
    return sum(c["queries"] for c in reqs) / ctx.window_s
