"""shard.write_order_ms: the program's LAST_STAGES["write_order_ms"] (span
mvs.write.order inside the write span: the (row, column) order of the kept
pairs, an O(n) check and a sort only where it fails), the mean over the
window's shards; nothing where the program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "write_order_ms")
