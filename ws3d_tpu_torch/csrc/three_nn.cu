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
// What bounds it on the H100: the n * m distance scan, about 10 operations a
// pair (FP-0 of one scene is 16384 x 4096 pairs), against 12 bytes a point
// in and 24 bytes a point out.
//
// Design: one thread per unknown point, 128 a block; the known points pass
// through shared memory in tiles of 1024 and each thread keeps a running
// top-3 with strict < in ascending index. The scan is block_three_nn in
// common.cuh, the same device code as the forward's interpolation kernel,
// so the backward weights the very neighbours the forward used.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kNNThreads)
three_nn_kernel(const float* __restrict__ unknown,
                const float* __restrict__ known, int n, int m,
                float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float tile[3 * kNNTile];
  const int tiles = (n + kNNThreads - 1) / kNNThreads;
  const int b = blockIdx.x / tiles;
  const int u = (blockIdx.x % tiles) * kNNThreads + threadIdx.x;
  const float* ub = unknown + (size_t)b * n * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (u < n) {
    qx = ub[3 * u];
    qy = ub[3 * u + 1];
    qz = ub[3 * u + 2];
  }
  float d[3];
  int nn[3];
  block_three_nn(known + (size_t)b * m * 3, m, qx, qy, qz, tile, d, nn);
  if (u < n) {
    const size_t o = ((size_t)b * n + u) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dist[o + k] = d[k];
      idx[o + k] = nn[k];
    }
  }
}

}  // namespace

// unknown (B, n, 3), known (B, m, 3) f32 -> dist (B, n, 3) f32 squared
// distances, idx (B, n, 3) int32.
WS3D_EXPORT int ws3d_three_nn(const float* unknown, const float* known, int B,
                              int n, int m, float* dist, int* idx,
                              void* stream) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int grid = B * ((n + kNNThreads - 1) / kNNThreads);
  three_nn_kernel<<<grid, kNNThreads, 0, (cudaStream_t)stream>>>(
      unknown, known, n, m, dist, idx);
  return (int)cudaGetLastError();
}
