"""Ingest of the port: sketching hash files into db folders with kernel P.
The on-disk contracts (hashes files, db folders) are the JAX package's host
modules, imported unchanged."""
