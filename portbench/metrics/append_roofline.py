"""append_roofline: kernel APPEND's share of its roofline over the window:
the operations that the window's shards need (2 P d a pair, every
unordered pair of a shard's rows with the diagonal and every pair of a
shard row with a row outside it; P from the db's largest component by the
limb rule) at the int8 peak, over APPEND's device time in the trace."""

from portbench import roofline

KERNEL = "retention_kernel<true"


def read(ctx):
    shards = [c for c in ctx.calls if c["kind"] == "shard"]
    if ctx.trace is None or not shards:
        return None
    bound = sum(roofline.append_bound_s(roofline.shard_pairs(c["rows"],
                                                             c["n"]),
                                        ctx.db["P"], ctx.db["d"])
                for c in shards)
    return roofline.share_pct(bound, ctx.trace.device_s(KERNEL))
