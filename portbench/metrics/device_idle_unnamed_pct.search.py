"""device_idle_unnamed_pct.search: of the device's idle time inside the
benchmark's spans around the requests, the share that no stage span of the
program (mvs.search.*) covers."""

from portbench import stages


def read(ctx):
    return stages.unnamed_idle_pct(ctx, "search")
