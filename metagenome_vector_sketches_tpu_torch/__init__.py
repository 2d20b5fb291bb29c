"""metagenome_vector_sketches_tpu_torch — the PyTorch/CUDA port.

Runs the main path of ``metagenome_vector_sketches_tpu`` (sketch ->
pairwise shard -> query) on an NVIDIA Hopper GPU through hand-written CUDA
kernels (``csrc/``), and on the CPU through each kernel's plain PyTorch
version. The host layers (db folder, hashes files, matrix reader, query
engine, codecs, FAISS index file) are the package's own copies of the JAX
package's JAX-free modules, byte for byte, so the port imports nothing of
the JAX package; the matrix writer is the port's own and writes the same
bytes as the JAX package's.

Every public entry point takes an explicit ``device``. A CUDA tensor always
goes through its kernel (or raises); the plain version runs only for tensors
that lie on the CPU.
"""

__version__ = "0.1.0"
