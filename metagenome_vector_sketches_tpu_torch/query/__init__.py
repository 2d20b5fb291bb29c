"""User-facing query stack: top-k neighbor queries, sliced sub-matrix
queries, batching, and output writers."""
