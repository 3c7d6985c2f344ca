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

// 16-byte (cg) and 4- or 8-byte (ca) asynchronous copies into shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Opt a kernel in to `bytes` of dynamic shared memory (needed above the 48 KB
// default, which also counts the kernel's static shared memory).
static inline int ws3d_set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// ---- ball query scales: ball_query.cu (kernels 6, 6w) and fused_sa.cu ------

constexpr int kMaxScales = 4;

struct BallScales {
  int n;                 // scales in use, 1..kMaxScales
  float r2[kMaxScales];  // f32 rounding of the double product radius * radius
  int S[kMaxScales];     // samples per scale
};

// ---- 3-NN search: the staged search of kernels 4, 7 and 8 (search.cuh) ----

constexpr int kNNThreads = 128;  // threads a block of the 3-NN kernels

// Insert candidate (v, j) into a running top-3 ordered by (d2, index): the
// order of an ascending-index scan with strict < (the TPU's three masked-min
// passes), whatever order the candidates come in. Empty slots hold (inf, -1).
__device__ __forceinline__ void top3_insert(float v, int j, float (&d)[3],
                                            int (&i)[3]) {
  auto before = [](float a, int ia, float b, int ib) {
    return a < b || (a == b && ia < ib);
  };
  if (!before(v, j, d[2], i[2])) return;
  if (before(v, j, d[1], i[1])) {
    d[2] = d[1];
    i[2] = i[1];
    if (before(v, j, d[0], i[0])) {
      d[1] = d[0];
      i[1] = i[0];
      d[0] = v;
      i[0] = j;
    } else {
      d[1] = v;
      i[1] = j;
    }
  } else {
    d[2] = v;
    i[2] = j;
  }
}

// m < 3 known points: repeat the nearest in the empty slots.
__device__ __forceinline__ void top3_fill(float (&d)[3], int (&i)[3]) {
  if (i[1] < 0) {
    d[1] = d[0];
    i[1] = i[0];
  }
  if (i[2] < 0) {
    d[2] = d[0];
    i[2] = i[0];
  }
}
