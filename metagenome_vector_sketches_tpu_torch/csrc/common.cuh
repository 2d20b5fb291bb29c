// Shared declarations of the port's CUDA kernels (plain C interface,
// loaded with ctypes by metagenome_vector_sketches_tpu_torch/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MVS_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned kFullMask = 0xffffffffu;

// Every entry point launches, then reports the launch status: a refused
// launch (too many threads, too much shared memory) never runs, and a later
// synchronize would not report it.
static inline int mvs_launch_status() { return (int)cudaGetLastError(); }
