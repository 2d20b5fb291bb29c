"""search.rescore_ms: the program's mvs.search.rescore spans in the trace
(the hits' float64 Jaccard, filter and sort on the host), summed, over the
window's requests."""

from portbench import stages


def read(ctx):
    return stages.span_ms_per_call(ctx, "search", "mvs.search.rescore")
