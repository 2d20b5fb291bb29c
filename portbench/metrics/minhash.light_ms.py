"""minhash.light_ms: the program's LAST_STAGES["light_ms"] of each MinHash
shard (kernel C over the light postings, synchronised; span
mvs.minhash.light), the mean over the window's shards; nothing where the
program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "light_ms")
