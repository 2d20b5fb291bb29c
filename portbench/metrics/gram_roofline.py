"""gram_roofline: kernel G's share of its roofline over the window. A
MinHash shard of r rows of an N-set collection with H heavy hashes
(LAST_STAGES["heavy_hashes"]) needs 2 r N H operations (2 a
multiply-add of its rows' heavy incidence against every set's) at the int8
peak, or, if longer, its bytes at the HBM rate: the (r + N) x H incidence
read once and the r x N int32 counts written once. The bound over the
device time of the kernel (gemm_kernel<4>) in the trace; nothing where the
program has no such counter or kernel."""

from portbench import roofline

KERNEL = "gemm_kernel<4>"


def read(ctx):
    shards = [c for c in ctx.calls if c["kind"] == "shard"
              and "heavy_hashes" in c["stages"]]
    if ctx.trace is None or not shards:
        return None
    bound = 0.0
    for c in shards:
        r, n, h = c["rows"], c["n"], c["stages"]["heavy_hashes"]
        bound += roofline.bound_s(2.0 * r * n * h, roofline.INT8_PEAK,
                                  (r + n) * h + 4.0 * r * n)
    return roofline.share_pct(bound, ctx.trace.device_s(KERNEL))
