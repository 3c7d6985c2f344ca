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
//
// Kernel 6w, the same TPU kernel's wrap_pad mode (wrap_pad=True in
// ball_query_pallas; _bev_first_k_wrap_batched in the JAX pipeline, and here
// crop_membership of the proposal-database path): slot s takes the
// (s % cnt)-th in-ball point, cnt is the true in-ball count over all N, an
// empty ball gives 0 everywhere and count 0. The count needs every point, so
// nothing stops early; at the database path's shape (64 centres over a
// 16,384-point scene, S = 2048) the N-point scan of each centre bounds it,
// about 9 operations a point, with S * 4 bytes out a centre.
// Design: one block per query (block_rank_scan in common.cuh, shared with
// the crop kernels); the first min(cnt, S) member indices stay in shared
// memory (8 KB at S = 2048) and the block writes the S slots coalesced.
// All scales go in one launch, one scan per scale.
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

constexpr int kWrapThreads = 256;

struct WrapOut {
  int* idx[kMaxScales];  // per scale (B, M, S_i) int32
  int* cnt[kMaxScales];  // per scale (B, M) int32
};

__global__ void __launch_bounds__(kWrapThreads)
ball_query_wrap_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ new_xyz, int N, int M,
                       BallScales sc, WrapOut o) {
  extern __shared__ int members[];  // max S_i ints
  __shared__ int warp_cnt[kWrapThreads / 32];
  const int q = blockIdx.x;  // (b, m) flattened
  const float* pb = xyz + (size_t)(q / M) * N * 3;
  const float qx = new_xyz[3 * (size_t)q], qy = new_xyz[3 * (size_t)q + 1],
              qz = new_xyz[3 * (size_t)q + 2];
  for (int s = 0; s < sc.n; ++s) {
    const float r2 = sc.r2[s];
    const int S = sc.S[s];
    const int cnt = block_rank_scan<kWrapThreads>(
        0, N,
        [&](int i) {
          return sqdist3(qx - pb[3 * i], qy - pb[3 * i + 1],
                         qz - pb[3 * i + 2]) < r2;
        },
        S, members, warp_cnt);
    int* dst = o.idx[s] + (size_t)q * S;
    for (int k = threadIdx.x; k < S; k += kWrapThreads)
      dst[k] = cnt > 0 ? members[k % cnt] : 0;
    if (threadIdx.x == 0) o.cnt[s][q] = cnt;
    __syncthreads();  // the next scale reuses `members`
  }
}

}  // namespace

// Kernel 6w: xyz (B, N, 3), new_xyz (B, M, 3) f32; r2[s] and nsample[s] for
// n_scales scales; idx[s] a (B, M, nsample[s]) and cnt[s] a (B, M) int32
// device buffer.
WS3D_EXPORT int ws3d_ball_query_wrap(const float* xyz, const float* new_xyz,
                                     int B, int N, int M, int n_scales,
                                     const float* r2, const int* nsample,
                                     void* const* idx, void* const* cnt,
                                     void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || n_scales < 1 || n_scales > kMaxScales)
    return (int)cudaErrorInvalidValue;
  BallScales sc;
  WrapOut o;
  sc.n = n_scales;
  int max_s = 0;
  for (int s = 0; s < kMaxScales; ++s) {
    sc.r2[s] = s < n_scales ? r2[s] : 0.f;
    sc.S[s] = s < n_scales ? nsample[s] : 0;
    o.idx[s] = s < n_scales ? (int*)idx[s] : nullptr;
    o.cnt[s] = s < n_scales ? (int*)cnt[s] : nullptr;
    if (s < n_scales) {
      if (nsample[s] <= 0) return (int)cudaErrorInvalidValue;
      max_s = max(max_s, nsample[s]);
    }
  }
  const size_t smem = (size_t)max_s * sizeof(int);
  int err = ws3d_set_smem((const void*)ball_query_wrap_kernel, smem);
  if (err) return err;
  ball_query_wrap_kernel<<<B * M, kWrapThreads, smem, (cudaStream_t)stream>>>(
      xyz, new_xyz, N, M, sc, o);
  return (int)cudaGetLastError();
}

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
