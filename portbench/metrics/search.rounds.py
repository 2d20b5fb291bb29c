"""search.rounds: LAST_ADAPTIVE_STAGES["rounds"] (one shared scan a round)
of each request, the mean over the window's requests."""


def read(ctx):
    vals = [c["stages"]["rounds"] for c in ctx.calls if c["kind"] == "search"]
    return sum(vals) / len(vals) if vals else None
