"""Ingest of the port: sketching hash files into db folders with kernel P,
and the on-disk contracts it reads and writes (hashes files, signature
archives, db folders)."""
