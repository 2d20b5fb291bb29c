"""The port's pairwise engine (matrix shard production on the device). The
shard writer and reader are the JAX package's host modules."""
