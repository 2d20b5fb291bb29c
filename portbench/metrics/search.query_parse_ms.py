"""search.query_parse_ms: the program's mvs.search.parse_queries spans in
the trace (the query file parsed), summed, over the window's requests."""

from portbench import stages


def read(ctx):
    return stages.span_ms_per_call(ctx, "search", "mvs.search.parse_queries")
