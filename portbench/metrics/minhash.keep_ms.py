"""minhash.keep_ms: the program's LAST_STAGES["keep_ms"] of each MinHash
shard (kernel M's retention test and compaction, and the kept triples'
copy to the host; span mvs.minhash.keep), the mean over the window's
shards; nothing where the program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "keep_ms")
