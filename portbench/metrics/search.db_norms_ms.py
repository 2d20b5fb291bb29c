"""search.db_norms_ms: the program's mvs.search.db_norms spans in the
trace (the db folder's metadata and its vector_norms.txt parsed), summed,
over the window's requests."""

from portbench import stages


def read(ctx):
    return stages.span_ms_per_call(ctx, "search", "mvs.search.db_norms")
