"""search_p90_ms: the 90th percentile of the latency of the window's
requests, each timed from its due time to its return (a request that waits
behind a late one counts the wait), by linear interpolation between order
statistics."""

import numpy as np


def read(ctx):
    spans = [c["latency_ms"] for c in ctx.calls if c["kind"] == "search"]
    if not spans:
        return None
    return float(np.percentile(spans, 90))
