"""count_roofline: kernel COUNT's (retention_kernel<false, ...>, the
two-phase engine's counts sweep) share of its roofline over the window: 2 P
d operations a pair at the int8 peak, as append_roofline counts them, for
every pair the window's shards decide ((rows of a shard) x N: the
two-phase engine's counts sweep covers each shard row against every db
row), over COUNT's device time in the trace. Nothing where the window ran
no COUNT."""

from portbench import roofline

KERNEL = "retention_kernel<false"


def read(ctx):
    shards = [c for c in ctx.calls if c["kind"] == "shard"]
    if ctx.trace is None or not shards:
        return None
    bound = sum(roofline.count_bound_s(c["rows"] * c["n"], ctx.db["P"],
                                       ctx.db["d"]) for c in shards)
    return roofline.share_pct(bound, ctx.trace.device_s(KERNEL))
