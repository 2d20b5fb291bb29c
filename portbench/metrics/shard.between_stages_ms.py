"""shard.between_stages_ms: the program's LAST_STAGES["total_ms"] less the
stage walls it sums (stage, sweep, extract, finalize, write): the host's
combine of kernel X's partials into exact dots and the bookkeeping between
the stages, the mean over the window's shards."""

STAGES = ("stage_ms", "sweep_ms", "extract_ms", "finalize_ms", "write_ms")


def read(ctx):
    vals = [c["stages"]["total_ms"] - sum(c["stages"][k] for k in STAGES)
            for c in ctx.calls if c["kind"] == "shard"]
    return sum(vals) / len(vals) if vals else None
