"""shard.entry_ms: the program's LAST_STAGES["entry_ms"] (span
mvs.shard.entry: the entry's checks, the db's metadata, the norms parse and
scan_max_abs; the inside counterpart of shard.entry_host_ms), the mean over
the window's shards."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "entry_ms")
