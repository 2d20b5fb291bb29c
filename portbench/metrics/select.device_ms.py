"""select.device_ms: device time of kernel K (every kernel of csrc/select.cu:
select_chunk_kernel, select_radix_kernel, select_sort_kernel, ...) in the
trace, per request."""

import re

KERNEL = re.compile(r"(?:^|::|\s)select_[a-z_]*kernel")


def read(ctx):
    reqs = [c for c in ctx.calls if c["kind"] == "search"]
    if ctx.trace is None or not reqs:
        return None
    t = sum(e - s for s, e, name in ctx.trace.device if KERNEL.search(name))
    return 1e3 * t / len(reqs) if t > 0 else None
