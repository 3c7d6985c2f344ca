// Fused 3-NN inverse-squared-distance interpolation.
//
// Replaces the TPU kernel ws3d_tpu/ops/three_nn_pallas.py:_interp_kernel
// (wrapper three_interpolate_pallas, reached through
// interpolate._interpolate_fused). Semantics: for each unknown point the
// three known points with the smallest d2 (the lowest index first on ties;
// the nearest repeated when m < 3), weights 1/(d2 + 1e-8) normalised, and the
// weighted sum of their feature rows. The TPU kernel built a dense (MT, m)
// weight matrix for one bf16 matmul; here the sum is three f32 row reads.
//
// What bounds it on the H100: the distance tests (about 10 operations a
// pair) against the feature bytes (m*C in, n*C out). A dense search tests
// every pair, n*m (FP0 of one scene is 16384 x 4096), which would bound it
// by the operations at FP0; at FP2/FP3 the bytes bound it. But on the main
// path both clouds are sorted by z, and a query's three neighbours lie
// within the z slab its third-best d2 spans: about 90 of FP0's 4096 known
// points (kernel 8's visits).
//
// Design: the staged search of search.cuh (ring_stage and its loop) over the
// known cloud's 32-point chunks, whose z ranges a pre-pass writes into the
// workspace the wrapper allocates. A block of 128 threads takes 128 * kQPT
// consecutive queries, kQPT a thread in registers, so one staged known
// point (three broadcast shared loads) serves kQPT queries. The visit order
// starts at the chunk nearest the block's query z range and steps outward,
// alternating sides; warp 0 stages a chunk unless its z term from the
// block's query z range is strictly greater than the largest third-best d2
// of the block, and a warp skips a staged chunk whose z term from the
// warp's query z range is strictly greater than the warp's largest
// third-best d2 (strictly: an equal d2 can still win a tie towards a lower
// index). Every point of a skipped chunk has a larger d2 than the final
// third neighbour, so the result is the full search's on any input. Since
// candidates come out of index order, the running top-3 is ordered by
// (d2, index) (top3_insert), which is the order of the TPU's three
// masked-min passes and of kernel 7's ascending scan. The weights and the
// three-row sum are the arithmetic they were, so kernel 8 stays bit-equal.
// The library launches kQPT 1: csrc/bench/neighbour_search.cu measures 2
// and 4 too, and more queries a thread lost at every main-path shape (the
// pruned search leaves few pairs to share a load, and the registers cut
// the warps that hide latency); the launch bounds ask for
// kInterpMinBlocks blocks an SM, 64 registers a thread (the bench measures
// 4 and 12 too; at 12, 40 registers a thread, the kernel spills).
// Small launches (FP2, FP3: a few thousand queries, 512 channels) would
// leave most SMs idle, so below two blocks an SM, where the known cloud is
// small beside the channels, the host splits the channels over blocks,
// each block searching its queries again. The block writes the output rows
// with threads across channels (coalesced).
//
// Kernel 8 (three_interp_window_kernel) replaces the TPU kernel
// three_nn_pallas.py:_window_interp_kernel (wrapper
// three_interpolate_window_pallas, interpolate_features(sorted_z=True)): the
// same function for clouds sorted ascending by z, with a search that visits
// only the known points near each query in z. One thread per query (queries
// are z-sorted too, so a warp's searches overlap): a binary search finds the
// query's home in the known z, then the search steps outward, always to the
// side whose next point is nearer in z, and keeps a running top-3 ordered
// by (d2, index) (top3_insert). A side stops once its next point's own z
// term fl(dz)^2 is greater than the current third-best d2: d2 is at least
// that term (term-rounded sqdist3, each sum rounds upwards of its terms) and
// the term only grows along the side, so nothing beyond can enter. Strictly
// greater: an equal d2 can still win a tie towards a lower index. The result
// is kernel 7's neighbours exactly, and the weights and the gather below are
// kernel 4's arithmetic, so the output is bit-equal to kernel 4. What bounds
// it: the candidates inside the windows (about 10 operations each), against
// the same feature bytes as kernel 4.
#include <stdint.h>

#include <algorithm>

#include "search.cuh"

namespace {

constexpr int kQ = kNNThreads;  // threads a block
constexpr int kInterpMinBlocks = 8;  // kernel 4's launch bound: blocks an SM

// Warp 0 stages kernel 4's next tile into `slot`: the next chunks of the
// visit order outward from the home chunk st[0] (positions 0, 1, 2, ...
// are home, home - 1, home + 1, home - 2, ...) whose z term from the
// block's query z range zr is not above tb; st[1] is the cursor.
__device__ __forceinline__ void interp_stage(const float* __restrict__ kb,
                                             int m,
                                             const float2* __restrict__ bb,
                                             bool a16, const TileRing& ring,
                                             int slot, float tb,
                                             const float* zr, int* st) {
  const int nch = n_chunks(m), home = st[0];
  const float zlo = zr[0], zhi = zr[1];
  int pos = st[1];
  ring_stage(
      kb, m, bb, a16, 2 * max(home, nch - 1 - home) + 1,
      [=](int p) {
        const int c = (p & 1) ? home - ((p + 1) >> 1) : home + (p >> 1);
        return c >= 0 && c < nch ? c : -1;
      },
      [=](float2 b) { return !(zterm_hull(zlo, zhi, b) > tb); }, pos, ring,
      slot);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) st[1] = pos;
}

// One staged known point u (index j0 + u) against a thread's kQPT queries:
// inserted where its d2 is not above the third-best (top3_insert breaks a
// tie by index).
template <int kQPT>
__device__ __forceinline__ void interp_point(
    const float* tp, int u, int j0, const float (&qx)[kQPT],
    const float (&qy)[kQPT], const float (&qz)[kQPT], float (&d)[kQPT][3],
    int (&nn)[kQPT][3]) {
  const float px = tp[3 * u], py = tp[3 * u + 1], pz = tp[3 * u + 2];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const float v = sqdist3(qx[i] - px, qy[i] - py, qz[i] - pz);
    if (v <= d[i][2]) top3_insert(v, j0 + u, d[i], nn[i]);
  }
}

// Kernel 4: a block takes 128 * kQPT consecutive unknown points of one
// batch row and channels [split * cg, split * cg + cg) of their output,
// cg = ceil(C / csplit), split = blockIdx.x % csplit.
template <int kQPT, int kMinBlocks>
__global__ void __launch_bounds__(kQ, kMinBlocks)
three_interp_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known,
                    const float2* __restrict__ bounds,
                    const float* __restrict__ feats, int n, int m, int C,
                    int csplit, int a16, float* __restrict__ out) {
  constexpr int kBQ = kQ * kQPT;  // queries a block
  constexpr int kW = kQ / 32;     // warps
  __shared__ __align__(16) float sring[kRingFloats];
  __shared__ int s_idx[kBQ][3];
  __shared__ float s_w[kBQ][3];
  __shared__ float s_zr[2][kW];
  __shared__ float s_blk[2];  // the block's query z range
  __shared__ unsigned s_tmin;
  __shared__ int s_home[2];
  __shared__ int s_st[2];     // warp 0's visit order: home, cursor
  const TileRing ring = ring_at(sring);
  const int tiles = (n + kBQ - 1) / kBQ;
  const int split = blockIdx.x % csplit;
  const int b = blockIdx.x / csplit / tiles;
  const int u0 = (blockIdx.x / csplit % tiles) * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* ub = unknown + (size_t)b * n * 3;
  const float* kb = known + (size_t)b * m * 3;
  const float2* bb = bounds + (size_t)b * n_chunks(m);
  const float* fb = feats + (size_t)b * m * C;
  const float inf = __int_as_float(0x7f800000);
  const int nch = n_chunks(m);

  // kQPT consecutive queries a thread; past n, copies of the last query
  float qx[kQPT], qy[kQPT], qz[kQPT], d[kQPT][3];
  int nn[kQPT][3];
  float wlo = inf, whi = -inf;
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int u = min(u0 + tid * kQPT + i, n - 1);
    qx[i] = ub[3 * u];
    qy[i] = ub[3 * u + 1];
    qz[i] = ub[3 * u + 2];
    d[i][0] = d[i][1] = d[i][2] = inf;
    nn[i][0] = nn[i][1] = nn[i][2] = -1;
    wlo = fminf(wlo, qz[i]);
    whi = fmaxf(whi, qz[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wlo = fminf(wlo, __shfl_xor_sync(0xffffffffu, wlo, o));
    whi = fmaxf(whi, __shfl_xor_sync(0xffffffffu, whi, o));
  }
  if (lane == 0) {
    s_zr[0][warp] = wlo;
    s_zr[1][warp] = whi;
    ring.warp_v[warp] = ring.warp_v[32 + warp] = inf;
  }
  if (tid == 0) {
    s_tmin = __float_as_uint(inf);
    s_home[0] = nch;
    s_home[1] = -1;
  }
  __syncthreads();
  if (tid == 0) {  // the block's query z range
    float lo = inf, hi = -inf;
    for (int w = 0; w < kW; ++w) {
      lo = fminf(lo, s_zr[0][w]);
      hi = fmaxf(hi, s_zr[1][w]);
    }
    s_blk[0] = lo;
    s_blk[1] = hi;
  }
  __syncthreads();
  // home: the middle of the chunks of least z term from the block's range
  for (int c = tid; c < nch; c += kQ)
    atomicMin(&s_tmin,
              __float_as_uint(zterm_hull(s_blk[0], s_blk[1], bb[c])));
  __syncthreads();
  for (int c = tid; c < nch; c += kQ) {
    if (__float_as_uint(zterm_hull(s_blk[0], s_blk[1], bb[c])) == s_tmin) {
      atomicMin(&s_home[0], c);
      atomicMax(&s_home[1], c);
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_st[0] = s_home[1] >= 0 ? (s_home[0] + s_home[1]) >> 1 : 0;
    s_st[1] = 0;
  }
  __syncthreads();

  // the staged loop of search.cuh; a warp's value is its largest
  // third-best d2, and warp 0 keeps its picking state in shared memory
  if (warp == 0)
    for (int s = 0; s < kStages - 1; ++s)
      interp_stage(kb, m, bb, a16 != 0, ring, s, inf, s_blk, s_st);
  for (int t = 0;; ++t) {
    if (warp == 0) ring_wait();
    __syncthreads();
    const int slot = t % kStages;
    const int nc = ring.cnt[slot];
    if (nc == 0) break;  // block-uniform
    if (warp == 0)
      interp_stage(kb, m, bb, a16 != 0, ring, (t + kStages - 1) % kStages,
                   ring_max(ring, (t + 1) & 1, kW), s_blk, s_st);
    for (int k = 0; k < nc; ++k) {
      // skipped when its z term from the warp's query range is above every
      // lane's third-best d2
      const float2 zb = ring.zb[slot * kTileChunks + k];
      float w3 = d[0][2];
#pragma unroll
      for (int i = 1; i < kQPT; ++i) w3 = fmaxf(w3, d[i][2]);
      if (__all_sync(0xffffffffu, zterm_hull(wlo, whi, zb) > w3)) continue;
      const int j0 = ring.cid[slot * kTileChunks + k] * kChunk;
      const float* tp = ring.pts + (slot * kTileChunks + k) * 3 * kChunk;
      if (m - j0 >= kChunk) {
#pragma unroll 8
        for (int u = 0; u < kChunk; ++u)
          interp_point<kQPT>(tp, u, j0, qx, qy, qz, d, nn);
      } else {
        for (int u = 0; u < m - j0; ++u)
          interp_point<kQPT>(tp, u, j0, qx, qy, qz, d, nn);
      }
    }
    float w3 = d[0][2];
#pragma unroll
    for (int i = 1; i < kQPT; ++i) w3 = fmaxf(w3, d[i][2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      w3 = fmaxf(w3, __shfl_xor_sync(0xffffffffu, w3, o));
    if (lane == 0) ring.warp_v[32 * (t & 1) + warp] = w3;
  }
  if (warp == 0) ring_drain();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    top3_fill(d[i], nn[i]);
    const float r0 = 1.0f / (d[i][0] + 1e-8f), r1 = 1.0f / (d[i][1] + 1e-8f),
                r2 = 1.0f / (d[i][2] + 1e-8f);
    const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
    const int q = tid * kQPT + i;
    s_idx[q][0] = nn[i][0];
    s_idx[q][1] = nn[i][1];
    s_idx[q][2] = nn[i][2];
    s_w[q][0] = r0 / norm;
    s_w[q][1] = r1 / norm;
    s_w[q][2] = r2 / norm;
  }
  __syncthreads();

  const int nu = min(kBQ, n - u0);
  const int cg = (C + csplit - 1) / csplit;
  const int c0 = split * cg, cw = min(C, c0 + cg) - c0;
  for (int t = tid; t < nu * cw; t += kQ) {
    const int q = t / cw, c = c0 + (t - q * cw);
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(fb[(size_t)s_idx[q][0] * C + c], s_w[q][0]),
                  __fmul_rn(fb[(size_t)s_idx[q][1] * C + c], s_w[q][1])),
        __fmul_rn(fb[(size_t)s_idx[q][2] * C + c], s_w[q][2]));
    out[((size_t)b * n + u0 + q) * C + c] = v;
  }
}

// Launches kernel 4 with kQPT queries a thread, registers for kMinBlocks
// blocks an SM and csplit channel groups after the pre-pass; returns a
// cudaError_t.
template <int kQPT, int kMinBlocks>
int launch_three_interp(int csplit, const float* unknown, const float* known,
                        const float* feats, int B, int n, int m, int C,
                        float* out, float2* bounds, cudaStream_t st) {
  const int err = launch_chunk_bounds(known, B, m, bounds, st);
  if (err) return err;
  const int a16 =
      (reinterpret_cast<uintptr_t>(known) & 15) == 0 && m % 4 == 0 ? 1 : 0;
  const long long blocks = (long long)B * ((n + kQ * kQPT - 1) / (kQ * kQPT));
  three_interp_kernel<kQPT, kMinBlocks>
      <<<(unsigned)(blocks * csplit), kQ, 0, st>>>(
          unknown, known, bounds, feats, n, m, C, csplit, a16, out);
  return (int)cudaGetLastError();
}

// Channel groups for kQPT queries a thread on `sms` SMs: where the known
// cloud is at most twice as many points as there are channels (a search
// repeated costs little beside the gather even when nothing is pruned),
// splits of at least 32 channels up to two blocks an SM, each split
// searching its queries again; else 1.
int three_interp_splits(int kqpt, int B, int n, int m, int C, int sms) {
  const long long nb = (long long)B * ((n + kQ * kqpt - 1) / (kQ * kqpt));
  if (m > 2 * C) return 1;
  return (int)std::min<long long>(
      std::max<long long>((2LL * sms + nb - 1) / nb, 1), (C + 31) / 32);
}

__global__ void __launch_bounds__(kQ)
three_interp_window_kernel(const float* __restrict__ unknown,
                           const float* __restrict__ known,
                           const float* __restrict__ feats, int n, int m,
                           int C, float* __restrict__ out,
                           int* __restrict__ idx_out,
                           float* __restrict__ d2_out) {
  __shared__ int s_idx[kQ][3];
  __shared__ float s_w[kQ][3];
  const int tiles = (n + kQ - 1) / kQ;
  const int b = blockIdx.x / tiles;
  const int u0 = (blockIdx.x % tiles) * kQ;
  const int tid = threadIdx.x;
  const int u = u0 + tid;
  const float* kb = known + (size_t)b * m * 3;
  const float* fb = feats + (size_t)b * m * C;
  const float inf = __int_as_float(0x7f800000);
  float d[3] = {inf, inf, inf};
  int nn[3] = {-1, -1, -1};
  if (u < n) {
    const float* q = unknown + ((size_t)b * n + u) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    int a = 0, e = m;  // home: the first known point with z >= qz
    while (a < e) {
      const int mid = (a + e) >> 1;
      if (kb[3 * mid + 2] < qz) a = mid + 1;
      else e = mid;
    }
    int l = a - 1, r = a;
    float tl = 0.f, tr = 0.f;  // the z term of the next point of each side
    if (l >= 0) {
      const float dz = qz - kb[3 * l + 2];
      tl = __fmul_rn(dz, dz);
    }
    if (r < m) {
      const float dz = qz - kb[3 * r + 2];
      tr = __fmul_rn(dz, dz);
    }
    while (true) {
      const bool go_l = l >= 0 && !(tl > d[2]);
      const bool go_r = r < m && !(tr > d[2]);
      if (!go_l && !go_r) break;
      const int j = go_l && (!go_r || tl <= tr) ? l : r;
      top3_insert(sqdist3(qx - kb[3 * j], qy - kb[3 * j + 1],
                          qz - kb[3 * j + 2]),
                  j, d, nn);
      if (j == l) {
        if (--l >= 0) {
          const float dz = qz - kb[3 * l + 2];
          tl = __fmul_rn(dz, dz);
        }
      } else if (++r < m) {
        const float dz = qz - kb[3 * r + 2];
        tr = __fmul_rn(dz, dz);
      }
    }
    top3_fill(d, nn);
    if (idx_out != nullptr) {
      const size_t o = ((size_t)b * n + u) * 3;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        idx_out[o + t] = nn[t];
        d2_out[o + t] = d[t];
      }
    }
  }
  const float r0 = 1.0f / (d[0] + 1e-8f), r1 = 1.0f / (d[1] + 1e-8f),
              r2 = 1.0f / (d[2] + 1e-8f);
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  s_idx[tid][0] = nn[0];
  s_idx[tid][1] = nn[1];
  s_idx[tid][2] = nn[2];
  s_w[tid][0] = r0 / norm;
  s_w[tid][1] = r1 / norm;
  s_w[tid][2] = r2 / norm;
  __syncthreads();

  const int nu = min(kQ, n - u0);
  for (int t = tid; t < nu * C; t += kQ) {
    const int q = t / C, c = t - q * C;
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(fb[(size_t)s_idx[q][0] * C + c], s_w[q][0]),
                  __fmul_rn(fb[(size_t)s_idx[q][1] * C + c], s_w[q][1])),
        __fmul_rn(fb[(size_t)s_idx[q][2] * C + c], s_w[q][2]));
    out[((size_t)b * n + u0 + q) * C + c] = v;
  }
}

}  // namespace

// unknown (B, n, 3), known (B, m, 3), feats (B, m, C) f32 -> out (B, n, C);
// bounds a workspace of B * n_chunks(m) float2 (the pre-pass writes it).
WS3D_EXPORT int ws3d_three_interpolate(const float* unknown, const float* known,
                                       const float* feats, int B, int n, int m,
                                       int C, float* out, void* bounds,
                                       void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  return launch_three_interp<1, kInterpMinBlocks>(
                                three_interp_splits(1, B, n, m, C, sms),
                                unknown, known, feats, B, n, m, C, out,
                                (float2*)bounds, (cudaStream_t)stream);
}

// Kernel 8: the same contract for unknown and known sorted ascending by z;
// idx_out and d2_out ((B, n, 3) int32 / f32, or both null) receive the
// neighbours and their d2.
WS3D_EXPORT int ws3d_three_interpolate_window(const float* unknown,
                                              const float* known,
                                              const float* feats, int B, int n,
                                              int m, int C, float* out,
                                              int* idx_out, float* d2_out,
                                              void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || C <= 0 || (idx_out == nullptr) !=
                                                  (d2_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int grid = B * ((n + kQ - 1) / kQ);
  three_interp_window_kernel<<<grid, kQ, 0, (cudaStream_t)stream>>>(
      unknown, known, feats, n, m, C, out, idx_out, d2_out);
  return (int)cudaGetLastError();
}
