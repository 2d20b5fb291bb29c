"""Multi-device layer of the port: the mesh (an ordered tuple of torch
devices, one slot each, plus an optional process group), the mesh-sharded
pairwise engine, the sharded sweep statistics and distributed top-k, the
fused pipeline step and multi-process runs on ``torch.distributed``.

Port of ``metagenome_vector_sketches_tpu/parallel/``. Where the JAX package
runs one ``shard_map`` program over a ``jax.sharding.Mesh``, the port
launches its kernels on every slot (each CUDA slot on its own stream, all
slots before any is synchronised) and gathers the slots' results on the
first slot's device; between processes the gather is a
``torch.distributed`` all-gather (NCCL for CUDA devices, gloo on the CPU).
"""
