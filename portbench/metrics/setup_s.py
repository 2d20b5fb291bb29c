"""setup_s: seconds from the start of the run to the start of the measured
window (imports, the inputs made from the seed, the program's build and
load, staging, warm-up)."""


def read(ctx):
    return ctx.setup_s
