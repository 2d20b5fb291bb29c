"""minhash.cooccurrences: the program's LAST_STAGES["light_cooccurrences"]
of each MinHash shard (kernel C's increments: one a (member in the shard's
rows, member) pair of each light posting), the mean over the window's
shards; nothing where the program has no such counter."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "light_cooccurrences")
