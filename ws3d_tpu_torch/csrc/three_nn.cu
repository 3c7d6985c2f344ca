// 3-nearest-neighbour search: squared distances and indices.
//
// Replaces the TPU kernel ws3d_tpu/ops/three_nn_pallas.py:_kernel (wrapper
// three_nn_pallas, which interpolate.three_nn dispatches on the TPU). The
// port runs it in the backward of the FP interpolation, which needs the
// neighbours and weights of the forward again. Semantics: for each unknown
// point the three known points with the smallest d2, the lowest index first
// on ties, the nearest repeated when m < 3; d2 is emitted (not the distance).
// The TPU kernel made three masked-min passes over a VMEM (MT, m) block;
// here no distance block exists.
//
// What bounds it on the H100: a dense search tests n * m pairs, about 10
// operations each (FP-0 of one scene is 16384 x 4096), against 12 bytes a
// point in and 24 bytes a query out. On the stage-1 step both clouds are
// sorted by z (the FP levels of the backbone), and a query's three
// neighbours lie within the z slab its third-best d2 spans: the pairs the
// plain windowed search (ops/interpolate.py:window_search) visits, about 90
// a query at FP-0.
//
// Design: staged_three_nn (search.cuh), the search of kernel 4's forward
// (interpolate.cu), so the backward weights the very neighbours the forward
// used: a pre-pass writes the known cloud's 32-point chunk z ranges into the
// caller's workspace (or the caller passes the ranges the forward's pre-pass
// wrote for the same cloud), then a block of 128 threads takes 128 * kQPT
// consecutive queries and stages only the chunks that can still hold a
// neighbour (exact on any input; see search.cuh). Each thread writes its
// queries' d2 and indices; a warp's rows are contiguous. The library
// launches kQPT 1 with launch bounds for kNNMinBlocks blocks an SM: 2 and
// 4 queries a thread and 4 and 12 blocks an SM were measured too (PERF.md
// §6).
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int kNNMinBlocks = 8;  // the launch bound: blocks an SM

template <int kQPT, int kMinBlocks>
__global__ void __launch_bounds__(kNNThreads, kMinBlocks)
three_nn_kernel(const float* __restrict__ unknown,
                const float* __restrict__ known,
                const float2* __restrict__ bounds, int n, int m, int a16,
                float* __restrict__ dist, int* __restrict__ idx) {
  constexpr int kBQ = kNNThreads * kQPT;  // queries a block
  const int tiles = (n + kBQ - 1) / kBQ;
  const int b = blockIdx.x / tiles;
  const int u0 = (blockIdx.x % tiles) * kBQ;
  float d[kQPT][3];
  int nn[kQPT][3];
  staged_three_nn<kQPT>(unknown + (size_t)b * n * 3, n, u0,
                        known + (size_t)b * m * 3, m,
                        bounds + (size_t)b * n_chunks(m), a16 != 0, d, nn);
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int u = u0 + threadIdx.x * kQPT + i;
    if (u < n) {
      const size_t o = ((size_t)b * n + u) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dist[o + k] = d[i][k];
        idx[o + k] = nn[i][k];
      }
    }
  }
}

// Launches kernel 7 with kQPT queries a thread and registers for kMinBlocks
// blocks an SM, after the pre-pass unless `fill` is 0 (bounds already hold
// the known cloud's chunk ranges); returns a cudaError_t.
template <int kQPT, int kMinBlocks>
int launch_three_nn(const float* unknown, const float* known, int B, int n,
                    int m, float* dist, int* idx, float2* bounds, int fill,
                    cudaStream_t st) {
  if (fill) {
    const int err = launch_chunk_bounds(known, B, m, bounds, st);
    if (err) return err;
  }
  const int a16 =
      (reinterpret_cast<uintptr_t>(known) & 15) == 0 && m % 4 == 0 ? 1 : 0;
  const long long grid =
      (long long)B * ((n + kNNThreads * kQPT - 1) / (kNNThreads * kQPT));
  three_nn_kernel<kQPT, kMinBlocks><<<(unsigned)grid, kNNThreads, 0, st>>>(
      unknown, known, bounds, n, m, a16, dist, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// unknown (B, n, 3), known (B, m, 3) f32 -> dist (B, n, 3) f32 squared
// distances, idx (B, n, 3) int32; bounds a workspace of B * n_chunks(m)
// float2, which the pre-pass writes when fill_bounds is not 0 (else it
// must hold the chunk ranges of this known cloud from an earlier pre-pass).
WS3D_EXPORT int ws3d_three_nn(const float* unknown, const float* known, int B,
                              int n, int m, float* dist, int* idx,
                              void* bounds, int fill_bounds, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  return launch_three_nn<1, kNNMinBlocks>(unknown, known, B, n, m, dist, idx,
                                          (float2*)bounds, fill_bounds,
                                          (cudaStream_t)stream);
}
