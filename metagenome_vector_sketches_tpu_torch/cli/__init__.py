"""Command-line tools of the port, with the JAX package's flags plus
``--device`` (default ``cuda``; they refuse to run when CUDA is missing
unless ``--device cpu`` is given)."""
