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
// operations a point tested, against 12 bytes a point read and the index
// bytes written. An index-order scan tests every point up to the S_i-th hit
// of the scale that fills last; at the backbone's SA-1 shape (16 x 4096
// queries over 16384 points, r = 0.1 with S = 16 and r = 0.5 with S = 32)
// hardly any ball fills, so that scan tests all 16384 points a query. But
// the clouds of the main path are sorted by z (cfg.TPU.SORT_POINTS_Z, and
// every SA stage re-sorts its picks), so a query's in-ball points lie in a
// thin z slab: a few hundred of the 16384 at SA-1. Only those need testing.
//
// Design: a pre-pass writes each 32-point chunk's z range into the
// workspace the wrapper allocates (launch_chunk_bounds, in search.cuh); then
// a block of 8 warps takes 16 consecutive queries, 2 a warp, and runs
// block_ball_query (search.cuh, shared with the fused SA, kernels 2 and 3):
// warp 0 walks the chunks in ascending index and stages those that any
// query may still need (the chunk's z term from the block's query z range
// below the largest r2 still unfilled) into a ring of shared-memory tiles
// with cp.async, a tile ahead, while every warp tests the tile that has
// arrived. A warp skips a chunk for a query whose own z term reaches the r2
// of every unfilled scale of that query; a skipped chunk holds no hit, so
// the ascending-index ranks (ballot + popc) and the early stop are those of
// the full scan, on any input. Each staged point is read from shared memory
// once for the warp's 2 queries. d2 is sqdist3 (term-rounded, as the plain
// version). The rows are built in shared memory and written out coalesced.
// On an unsorted cloud every chunk spans the z range and nothing is
// skipped: the block then reads each point from global memory once for 16
// queries, where the index-order scan read it once a query. 2 queries a
// warp: 1 and 4 were measured too (PERF.md §6); 2 is fastest
// at the stage-1 launches, 4 at the RCNN step's SA0 and SA1.
//
// Kernel 6w, the same TPU kernel's wrap_pad mode (wrap_pad=True in
// ball_query_pallas; _bev_first_k_wrap_batched in the JAX pipeline, and here
// crop_membership of the proposal-database path): slot s takes the
// (s % cnt)-th in-ball point, cnt is the true in-ball count over all N, an
// empty ball gives 0 everywhere and count 0. The count needs every in-ball
// point, so nothing stops early; but on the database path (64 centres over
// a 16,384-point scene sorted by z, invalid points moved to z = 1e6 at its
// tail; r = 4 m, S = 2048) only the points of a centre's 4 m z slab can be
// in its ball, and the bytes bound it (12 bytes a point in, S * 4 out a
// centre) beside about 9 operations a slab point. Design: the pre-pass of
// search.cuh writes the chunk z ranges; a centre tests only the chunks
// whose z term from it is below r2 (exact: every d2 into another chunk is
// at least r2), in ascending index and never stopping, so the count and
// the ranks are the full scan's on any input. At batch 1 the 64 centres
// arrive in score order, not z order, and would leave half the card idle
// one to a warp, so a block of 16 warps takes one centre: it lists the
// centre's chunks, then its warps test them in rounds, 4 consecutive
// chunks a warp with the points read straight from global memory (L2), a
// count a warp and a block prefix ranking the members (listed_rank_search
// in search.cuh; the crop-gather, kernels 5 and 10, runs it too).
// The alternatives were measured (PERF.md §6): 8 or 32 warps,
// 2 or 8 chunks a warp a round, and the staged ring of search.cuh (one
// centre a block, or 2-8 centres taken in z order), which lost: every tile
// waits on warp 0's walk over the chunk bounds and on its copies. The
// first min(cnt, S) member indices stay in shared memory (8 KB at S =
// 2048) and the S slots go out coalesced. All scales go in one launch, one
// pass per scale.
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int kBQWarps = 8;
constexpr int kBQPerWarp = 2;                          // queries a warp

struct BQOut {
  int* out[kMaxScales];  // per scale (B, M, S_i) int32
};

// Kernel 6: a block of kBQWarps warps takes kBQWarps * kQW consecutive
// queries of one batch row.
template <int kQW>
__global__ void __launch_bounds__(kBQWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz,
                  const float2* __restrict__ bounds, int N, int M,
                  BallScales sc, BQOut o, int row_len, int a16) {
  constexpr int kQueries = kBQWarps * kQW;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const TileRing ring = ring_at(smem);
  float* qs = smem + kRingFloats;                          // 3 a query
  int* srows = reinterpret_cast<int*>(qs + 3 * kQueries);  // row_len a query
  const int groups = (M + kQueries - 1) / kQueries;
  const int b = blockIdx.x / groups;
  const int q0 = (blockIdx.x % groups) * kQueries;
  const int nq = min(kQueries, M - q0);
  for (int t = threadIdx.x; t < 3 * nq; t += blockDim.x)
    qs[t] = new_xyz[((size_t)b * M + q0) * 3 + t];
  __syncthreads();
  BallRows rows;
  rows.base = srows;
  rows.stride = row_len;
  int off = 0;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    rows.off[s] = off;
    if (s < sc.n) off += sc.S[s];
  }
  block_ball_query<kQW>(xyz + (size_t)b * N * 3, N,
                        bounds + (size_t)b * n_chunks(N), a16 != 0, qs, nq,
                        sc, rows, ring);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < sc.n) {
      const int S = sc.S[s];
      int* dst = o.out[s] + ((size_t)b * M + q0) * S;
      for (int t = threadIdx.x; t < nq * S; t += blockDim.x) {
        const int q = t / S;
        dst[t] = srows[q * row_len + rows.off[s] + (t - q * S)];
      }
    }
  }
}

// Launches kernel 6 with kQW queries a warp after the pre-pass; returns a
// cudaError_t.
template <int kQW>
int launch_ball_query(const float* xyz, const float* new_xyz, int B, int N,
                      int M, const BallScales& sc, const BQOut& o,
                      int row_len, float2* bounds, cudaStream_t st) {
  constexpr int kQueries = kBQWarps * kQW;
  const size_t smem = sizeof(float) * (kRingFloats + 3 * kQueries +
                                       (size_t)kQueries * row_len);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (smem > 48 * 1024)
    err = ws3d_set_smem((const void*)ball_query_kernel<kQW>, smem);
  if (!err) err = launch_chunk_bounds(xyz, B, N, bounds, st);
  if (err) return err;
  const int a16 =
      (reinterpret_cast<uintptr_t>(xyz) & 15) == 0 && N % 4 == 0 ? 1 : 0;
  const long long grid = (long long)B * ((M + kQueries - 1) / kQueries);
  ball_query_kernel<kQW><<<(unsigned)grid, kBQWarps * 32, smem, st>>>(
      xyz, new_xyz, bounds, N, M, sc, o, row_len, a16);
  return (int)cudaGetLastError();
}

constexpr int kWrapWarps = 16;  // warps a centre (a block)
constexpr int kWrapRound = 4;   // chunks a warp tests a round

struct WrapOut {
  int* idx[kMaxScales];  // per scale (B, M, S_i) int32
  int* cnt[kMaxScales];  // per scale (B, M) int32
};

// Kernel 6w: a block of kWarps warps takes one centre. For each scale it
// runs listed_rank_search (search.cuh, shared with kernels 5 and 10) over
// the chunks whose z term from the centre is below r2, kU chunks a warp a
// round; the first min(cnt, S) members stay in shared memory (max_s ints)
// and the S slots, members[s % cnt], go out coalesced.
template <int kWarps, int kU>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_wrap_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ new_xyz,
                       const float2* __restrict__ bounds, int N, int M,
                       BallScales sc, WrapOut o) {
  extern __shared__ int members[];  // max_s
  __shared__ ListedScratch<kWarps> s_scratch;
  const int q = blockIdx.x;  // (b, m) flattened
  const int nch = n_chunks(N);
  const float* pb = xyz + (size_t)(q / M) * N * 3;
  const float2* bb = bounds + (size_t)(q / M) * nch;
  const float qx = new_xyz[3 * (size_t)q], qy = new_xyz[3 * (size_t)q + 1],
              qz = new_xyz[3 * (size_t)q + 2];
  for (int s = 0; s < sc.n; ++s) {
    const float r2 = sc.r2[s];
    const int S = sc.S[s];
    const int cnt = listed_rank_search<kWarps, kU>(
        0, nch, [&](int c) { return zterm(qz, bb[c]) < r2; },
        [&](int j) {
          const float* p = pb + 3 * (size_t)j;
          return j < N && sqdist3(qx - p[0], qy - p[1], qz - p[2]) < r2;
        },
        S, members, s_scratch);
    int* dst = o.idx[s] + (size_t)q * S;
    for (int k = threadIdx.x; k < S; k += kWarps * 32)
      dst[k] = cnt > 0 ? members[k % cnt] : 0;
    if (threadIdx.x == 0) o.cnt[s][q] = cnt;
    __syncthreads();  // the next scale reuses `members`
  }
}

// Launches kernel 6w with kWarps warps a centre and kU chunks a warp a
// round after the pre-pass; max_s is the largest S; returns a cudaError_t.
template <int kWarps, int kU>
int launch_ball_query_wrap(const float* xyz, const float* new_xyz, int B,
                           int N, int M, const BallScales& sc,
                           const WrapOut& o, int max_s, float2* bounds,
                           cudaStream_t st) {
  const size_t smem = sizeof(int) * (size_t)max_s;
  const int err = prepare_listed_launch(
      (const void*)ball_query_wrap_kernel<kWarps, kU>, smem,
      sizeof(ListedScratch<kWarps>), xyz, B, N, bounds, st);
  if (err) return err;
  ball_query_wrap_kernel<kWarps, kU>
      <<<(unsigned)((long long)B * M), kWarps * 32, smem, st>>>(
          xyz, new_xyz, bounds, N, M, sc, o);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 6w: xyz (B, N, 3), new_xyz (B, M, 3) f32; r2[s] and nsample[s] for
// n_scales scales; idx[s] a (B, M, nsample[s]) and cnt[s] a (B, M) int32
// device buffer; bounds a workspace of B * n_chunks(N) float2 (the
// pre-pass writes it).
WS3D_EXPORT int ws3d_ball_query_wrap(const float* xyz, const float* new_xyz,
                                     int B, int N, int M, int n_scales,
                                     const float* r2, const int* nsample,
                                     void* const* idx, void* const* cnt,
                                     void* bounds, void* stream) {
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
  return launch_ball_query_wrap<kWrapWarps, kWrapRound>(
      xyz, new_xyz, B, N, M, sc, o, max_s, (float2*)bounds,
      (cudaStream_t)stream);
}

// xyz (B, N, 3), new_xyz (B, M, 3) f32; r2[s] and nsample[s] for n_scales
// scales; outs[s] a (B, M, nsample[s]) int32 device buffer; bounds a
// workspace of B * n_chunks(N) float2 (the pre-pass writes it).
WS3D_EXPORT int ws3d_ball_query(const float* xyz, const float* new_xyz, int B,
                                int N, int M, int n_scales, const float* r2,
                                const int* nsample, void* const* outs,
                                void* bounds, void* stream) {
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
  return launch_ball_query<kBQPerWarp>(xyz, new_xyz, B, N, M, sc, o, row_len,
                                       (float2*)bounds, (cudaStream_t)stream);
}
