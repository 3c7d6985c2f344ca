// Multi-scale ball query: the first S_i in-ball point indices per query and
// radius scale.
//
// Replaces the TPU kernel ws3d_tpu/ops/ball_query_pallas.py:_kernel (wrapper
// ball_query_pallas, pad-with-first mode; reached through
// grouping.ball_query_multi from every training-mode SA stage). Semantics:
// for each query and scale the first S_i points with d2 < r2_i in ascending
// index order, padded with the first hit, all 0 when the ball is empty.
// The TPU kernel built prefix sums of the in-ball mask on the MXU (matmuls
// with triangular ones matrices) over a VMEM-resident distance block; here
// the rank of a hit is a warp ballot + popc, and no distance block exists.
//
// What bounds it on the H100: the distance tests, about 8 + n_scales
// operations per point tested, against 12 bytes a point read (from L1/L2:
// a scene's points are at most 196 KB) and the index bytes written. At the
// backbone's SA-1 shape (16 x 4096 queries over 16384 points, r = 0.1 with
// S = 16 and r = 0.5 with S = 32) the small radius rarely fills, so most
// queries test every point: the operations bound it.
//
// Design: one warp per query (8 a block) scans the points in ascending
// index, 32 at a time, computes d2 once (sqdist3: term-rounded, as the
// plain version) and tests it against every scale, ranks each scale's hits
// with ballot + popc, and stops once every scale holds its S_i hits
// (warp_ball_query in common.cuh, shared with the fused SA kernel). The rows
// are built in shared memory and written out coalesced. The JAX kernel scans
// all points too; a z-window over the sorted cloud is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // queries per block

struct BQOut {
  int* out[kMaxScales];  // per scale (B, M, S_i) int32
};

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int BM, int N, int M,
                  BallScales sc, BQOut o, int row_len) {
  extern __shared__ int srows[];  // kWarps * row_len
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;  // (b, m) flattened
  if (q >= BM) return;                       // whole warp
  const int b = q / M;
  const float qx = new_xyz[3 * (size_t)q], qy = new_xyz[3 * (size_t)q + 1],
              qz = new_xyz[3 * (size_t)q + 2];
  int* rows[kMaxScales];
  int off = warp * row_len;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    rows[s] = srows + off;
    if (s < sc.n) off += sc.S[s];
  }
  warp_ball_query(xyz + (size_t)b * N * 3, 0, N, qx, qy, qz, sc, rows);
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < sc.n) {
      int* dst = o.out[s] + (size_t)q * sc.S[s];
      for (int k = lane; k < sc.S[s]; k += 32) dst[k] = rows[s][k];
    }
  }
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) f32; r2[s] and nsample[s] for n_scales
// scales; outs[s] a (B, M, nsample[s]) int32 device buffer.
WS3D_EXPORT int ws3d_ball_query(const float* xyz, const float* new_xyz, int B,
                                int N, int M, int n_scales, const float* r2,
                                const int* nsample, void* const* outs,
                                void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || n_scales < 1 || n_scales > kMaxScales)
    return (int)cudaErrorInvalidValue;
  BallScales sc;
  BQOut o;
  sc.n = n_scales;
  int row_len = 0;
  for (int s = 0; s < kMaxScales; ++s) {
    sc.r2[s] = s < n_scales ? r2[s] : 0.f;
    sc.S[s] = s < n_scales ? nsample[s] : 0;
    o.out[s] = s < n_scales ? (int*)outs[s] : nullptr;
    if (s < n_scales) {
      if (nsample[s] <= 0) return (int)cudaErrorInvalidValue;
      row_len += nsample[s];
    }
  }
  const size_t smem = (size_t)kWarps * row_len * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long BM = (long long)B * M;
  const int grid = (int)((BM + kWarps - 1) / kWarps);
  ball_query_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      xyz, new_xyz, (int)BM, N, M, sc, o, row_len);
  return (int)cudaGetLastError();
}
