// Shared helpers for the ws3d_tpu_torch CUDA kernels (sm_90a).
//
// Every host entry point has a plain C interface (loaded with ctypes), takes
// device pointers and the caller's stream, launches, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define WS3D_EXPORT extern "C" __attribute__((visibility("default")))

// Squared distance with every product and sum rounded on its own: nvcc would
// otherwise contract a*a + b*b into FMAs, which moves d2 by an ulp against the
// plain PyTorch version and flips `d2 < r2` and argmax ties at the boundary.
__device__ __forceinline__ float sqdist3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float sqdist2(float dx, float dz) {
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
}

// Opt a kernel in to `bytes` of dynamic shared memory (needed above the 48 KB
// default, which also counts the kernel's static shared memory).
static inline int ws3d_set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}
