"""score_roofline: kernel SCORE's share of its roofline over the window. A
round of a request scans the db's whole plane stack once; its bytes are the
stack, the query planes and the float32 scores, counted for every query of
the request in the first round and for one query in each later round (the
least the inputs need: the frontier of a later round is not read). The
bound at the HBM rate over SCORE's device time in the trace."""

from portbench import roofline

KERNEL = "gemm_kernel"


def read(ctx):
    reqs = [c for c in ctx.calls if c["kind"] == "search"]
    if ctx.trace is None or not reqs:
        return None
    P, d, n = ctx.db["P"], ctx.db["d"], ctx.db["n"]
    bound = sum(roofline.score_bound_s(P, n, d, c["queries"])
                + (c["stages"]["rounds"] - 1) * roofline.score_bound_s(
                    P, n, d, 1) for c in reqs)
    return roofline.share_pct(bound, ctx.trace.device_s(KERNEL))
