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

// Makes `device` current for the calling thread in this library's CUDA
// runtime. nvcc links the library against its own static runtime, whose
// current device is per thread and separate from PyTorch's: the Python
// wrappers call this before every launch (_build.launch_stream), so a
// kernel runs on the device of its tensors, cuda:N as well as cuda:0.
// Weak: every source that includes this header defines it, and the
// linked library keeps one copy.
extern "C" __attribute__((visibility("default"), weak)) int mvs_set_device(
    int device) {
  return (int)cudaSetDevice(device);
}

// Largest device index the per-device caches of the kernels hold.
constexpr int kMaxDevices = 64;
