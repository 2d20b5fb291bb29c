"""minhash.heavy_ms: the program's LAST_STAGES["heavy_ms"] of each MinHash
shard (the heavy hashes' Gram rows, kernel G, synchronised; span
mvs.minhash.heavy), the mean over the window's shards; nothing where the
program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "heavy_ms")
