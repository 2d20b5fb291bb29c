"""metagenome_vector_sketches_tpu_torch — the PyTorch/CUDA port.

Runs the main path of ``metagenome_vector_sketches_tpu`` (sketch ->
pairwise shard -> query) on an NVIDIA Hopper GPU through hand-written CUDA
kernels (``csrc/``), and on the CPU through each kernel's plain PyTorch
version. The host layers (db folder, hashes files, matrix writer/reader,
query engine, codecs) do not depend on JAX and are imported from the JAX
package unchanged; this package reimplements only what runs on the device.

Every public entry point takes an explicit ``device``. A CUDA tensor always
goes through its kernel (or raises); the plain version runs only for tensors
that lie on the CPU.
"""

__version__ = "0.1.0"
