"""cooc_roofline: kernel C's (the light co-occurrences') share of its
roofline over the window, bound by bytes at the HBM rate. A MinHash shard
reads the light postings once, 4 B a member (LAST_STAGES["light_entries"])
and 8 B an offset (LAST_STAGES["light_postings"] + 1), and each counter
increment (LAST_STAGES["light_cooccurrences"]) reads and writes one 4 B
count: 8 B an increment. The bound over the device time of cooc_kernel in
the trace; nothing where the program has no such counters or kernel."""

from portbench import roofline

KERNEL = "cooc_kernel"


def read(ctx):
    shards = [c["stages"] for c in ctx.calls if c["kind"] == "shard"
              and "light_cooccurrences" in c["stages"]]
    if ctx.trace is None or not shards:
        return None
    nbytes = sum(4.0 * s["light_entries"] + 8.0 * (s["light_postings"] + 1)
                 + 8.0 * s["light_cooccurrences"] for s in shards)
    return roofline.share_pct(roofline.bound_s(nbytes=nbytes),
                              ctx.trace.device_s(KERNEL))
