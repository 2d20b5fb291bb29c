"""device_idle_pct.shard: the share of the traced window in which no
kernel, copy or set ran on the device (the union of the profiler's device
intervals), in a cell whose calls are shards."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not any(
            c["kind"] == "shard" for c in ctx.calls):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
