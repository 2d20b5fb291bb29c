"""keep_roofline: kernel X's keep epilogue's (partials_kernel<L, true>)
share of its roofline over the window. A shard's candidates
(LAST_STAGES["candidates"], the sweep's survivors and the self-pairs) need
2 L^2 d_pad operations each (the limb-pair multiply-adds) at the 67 TOP/s
core peak, or, if longer, their bytes at the HBM rate: 8 B a candidate read
and 16 B a kept record written (LAST_STAGES["pairs_written"], twins and
self-pairs included). L from the db's largest component by the limb rule,
d_pad the kernels' d rounded up to 64. The bound counts each candidate
once: the device time of every launch, reruns included, is the divisor.
Nothing where the window ran no such kernel."""

import re

from portbench import roofline
from portbench.reference import exact

KERNEL = re.compile(r"partials_kernel<\d+, ?true>")
D_ALIGN = 64


def read(ctx):
    shards = [c["stages"] for c in ctx.calls if c["kind"] == "shard"
              and "candidates" in c["stages"]]
    if ctx.trace is None or not shards:
        return None
    L = exact.limbs(max(1, ctx.db["max_abs"]))
    d_pad = -(-ctx.db["d"] // D_ALIGN) * D_ALIGN
    bound = sum(roofline.bound_s(2.0 * s["candidates"] * L * L * d_pad,
                                 roofline.CORE_PEAK,
                                 8.0 * s["candidates"]
                                 + 16.0 * s["pairs_written"])
                for s in shards)
    spent = sum(e - b for b, e, name in ctx.trace.device
                if KERNEL.search(name))
    return roofline.share_pct(bound, spent)
