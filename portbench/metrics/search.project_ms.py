"""search.project_ms: the program's mvs.search.project spans in the trace
(the queries projected, kernel P), summed, over the window's requests."""

from portbench import stages


def read(ctx):
    return stages.span_ms_per_call(ctx, "search", "mvs.search.project")
