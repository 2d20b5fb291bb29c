"""device_idle_unnamed_pct.shard: of the device's idle time inside the
benchmark's spans around the shards, the share that no stage span of the
program (mvs.shard.*) covers."""

from portbench import stages


def read(ctx):
    return stages.unnamed_idle_pct(ctx, "shard")
