"""shard.write_codec_ms: the program's LAST_STAGES["write_codec_ms"] (span
mvs.write.codec inside the write span: the row boundaries, the codecs of
the rows' records and the three files written), the mean over the window's
shards; nothing where the program has no such key."""

from portbench import stages


def read(ctx):
    return stages.mean_stage(ctx, "shard", "write_codec_ms")
