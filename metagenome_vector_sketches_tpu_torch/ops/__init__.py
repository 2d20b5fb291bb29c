"""Device ops of the port: splitmix64, projection (kernel P), plane staging,
the pairwise sweep (kernel S) and candidate partials (kernel X), plus the
numpy-only pairwise math."""
