"""The port's pairwise engine (matrix shard production on the device) and
the shard writer and reader on the host."""
