// The measurement behind the staged, pruned searches of kernels 6
// (csrc/ball_query.cu), 4 and 8 (csrc/interpolate.cu), 7 (csrc/three_nn.cu),
// 6w (csrc/ball_query.cu, wrap-pad mode) and 5 and 10 (csrc/crop_gather.cu):
// each against the search it replaced, at every launch shape of the main
// path, on z-sorted clouds and on the same clouds shuffled (kernel 8, whose
// old search holds only on sorted clouds, sorted only).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -Xcompiler -ffp-contract=off -o neighbour_search \
//       ws3d_tpu_torch/csrc/bench/neighbour_search.cu && ./neighbour_search
//
// Shapes: kernel 6 at the stage-1 train step's four SA stages (16 scenes) and
// the RCNN step's three backward stages (800 crops); kernels 4 and 8 at the
// inference batch's four FP stages (16 scenes) and the database's FP0 (one
// scene); kernel 7 at the stage-1 step's four FP stages (16 scenes: n 256 /
// 1,024 / 4,096 / 16,384 over m 64 / 256 / 1,024 / 4,096); kernel 6w at the
// proposal database's launch (one scene of 16,384 points with y zeroed and
// its last 3,000 moved to x = z = 1e6 as invalid points, 64 centres picked at
// random among the valid points, in that order, r 4 m, S 2,048); kernels 5
// and 10 at the inference batch's crop (16 scenes of 16,384 points, 64
// centres a scene taken among the points in a random order, the first far
// off, r 4 m, k 512, 5 channels, grouped slots; kernel 10 at the JAX default
// z_window of 32 tiles). Clouds are seeded and LiDAR-like (scenes: depth z in
// [0, 70] m biased to the near range, a ground layer and objects above it;
// crops: a 4 m disc of the same), sorted by z; the queries (kernel 6) and the
// known points (kernels 4 and 7) are every (N / M)-th point, so they stay
// sorted too. "shuffled" is the same points, queries and known points in a
// random order, where the z ranges of the chunks span the cloud and nothing
// is skipped (kernel 6w's and the crop's centres keep their order). The old
// searches: kernel 6 as one warp a query over all points in ascending index
// (warp_ball_query), kernels 4 and 7 as one thread a query over every known
// point through shared-memory tiles (block_three_nn), kernel 8 as one thread
// a query walking outward from the home a serial binary search finds (the
// ring walk), kernels 6w, 5 and 10 as one block a centre ranking all N
// points (block_rank_scan; kernel 10 over the z window thread 0 finds by
// serial binary searches). Each prints the
// CUDA-event time of both (mean of 5 launches after one warm-up; the new one
// with its pre-pass), the new one as the library launches it and with the
// other sizes it could take: kernel 6 with 1 and 4 queries a warp where it
// keeps 2; kernels 4 and 7 with launch bounds for 4 and 12 blocks an SM where
// they keep 8, and with 2 and 4 queries a thread where they keep 1; kernel 7
// also on the chunk bounds a pre-pass already wrote (the interpolation
// backward reuses its forward's); kernel 8 on each chunk's first and last z
// read in place, against kernel 4's launch with its pre-pass and without it
// on bounds written once, four rounds of each in turns; kernel 6w with 8 and 32
// warps a centre where it keeps 16, with 2 and 8 chunks a warp a round where
// it keeps 4, and on the staged ring of search.cuh with one centre a block
// and with 2 and 8 centres a block taken in z order; kernels 5 and 10 with
// 4, 8 and 16 warps a centre and 2, 4 and 8 chunks a warp a round.
// It exits 1 if any output differs from the old one by a bit, or if
// kernel 6's first row differs from a host ball query or kernel 5's first
// row's counts from the host's.
//
// Not part of the kernel library (csrc/*.cu only): it compiles
// ball_query.cu, crop_gather.cu, interpolate.cu and three_nn.cu into
// itself.
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <numeric>
#include <random>
#include <vector>

#include "../ball_query.cu"
#include "../crop_gather.cu"
#include "../interpolate.cu"
#include "../three_nn.cu"

namespace {

#define CHECK(x)                                                     \
  do {                                                               \
    const int e_ = (int)(x);                                         \
    if (e_) {                                                        \
      std::printf("%s:%d: %s\n", __FILE__, __LINE__,                 \
                  cudaGetErrorString((cudaError_t)e_));              \
      std::exit(1);                                                  \
    }                                                                \
  } while (0)

// Kernel 6's search before (and the fused SA's): one warp scans points
// [lo, hi) of `pts` ((x, y, z) rows) in ascending index, 32 at a time,
// computes each d2 once and tests it against every scale. rows[s] receives
// the first S[s] indices with d2 < r2[s], padded with the first hit, all 0
// when the ball is empty. The scan stops once every scale has its S hits.
__device__ __forceinline__ void warp_ball_query(
    const float* __restrict__ pts, int lo, int hi, float qx, float qy,
    float qz, const BallScales& sc, int* const* rows) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int cnt[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) cnt[s] = 0;
  bool full = false;
  for (int base = lo; base < hi && !full; base += 32) {
    const int j = base + lane;
    const float d = j < hi ? sqdist3(qx - pts[3 * j], qy - pts[3 * j + 1],
                                     qz - pts[3 * j + 2])
                           : __int_as_float(0x7f800000);
    full = true;
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s < sc.n) {  // warp-uniform
        const bool in = d < sc.r2[s];
        const unsigned m = __ballot_sync(0xffffffffu, in);
        const int rank = cnt[s] + __popc(m & below);
        if (in && rank < sc.S[s]) rows[s][rank] = j;
        cnt[s] += __popc(m);
        full = full && cnt[s] >= sc.S[s];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < sc.n) {
      const int n = min(cnt[s], sc.S[s]);
      const int first = n > 0 ? rows[s][0] : 0;
      for (int k = n + lane; k < sc.S[s]; k += 32) rows[s][k] = first;
    }
  }
  __syncwarp();
}

// kernel 6 before: one warp a query scans all N points in ascending index
__global__ void __launch_bounds__(256)
old_ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ new_xyz, int BM, int N, int M,
                      BallScales sc, BQOut o, int row_len) {
  extern __shared__ int srows[];  // 8 * row_len
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * 8 + warp;
  if (q >= BM) return;
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

// The 3-NN search of kernels 4 and 7 before: every known point for every
// query. The three known points of `kb` ((x, y, z) rows, m of them) nearest
// to (qx, qy, qz): a running top-3 with strict < over ascending indices;
// every thread of a kNNThreads-thread block calls it (it synchronises the
// block); `tile` is 3 * kNNTile floats of shared memory.
constexpr int kNNTile = 1024;  // known points per shared-memory tile

__device__ __forceinline__ void block_three_nn(const float* __restrict__ kb,
                                               int m, float qx, float qy,
                                               float qz, float* tile,
                                               float (&d)[3], int (&i)[3]) {
  float* kx = tile;
  float* ky = tile + kNNTile;
  float* kz = tile + 2 * kNNTile;
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  d[0] = d[1] = d[2] = inf;
  i[0] = i[1] = i[2] = -1;
  for (int t0 = 0; t0 < m; t0 += kNNTile) {
    const int cnt = min(kNNTile, m - t0);
    __syncthreads();
    for (int t = tid; t < cnt; t += kNNThreads) {
      kx[t] = kb[3 * (t0 + t)];
      ky[t] = kb[3 * (t0 + t) + 1];
      kz[t] = kb[3 * (t0 + t) + 2];
    }
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      const float v = sqdist3(qx - kx[t], qy - ky[t], qz - kz[t]);
      const int j = t0 + t;
      if (v < d[2]) {
        if (v < d[1]) {
          d[2] = d[1];
          i[2] = i[1];
          if (v < d[0]) {
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
    }
  }
  top3_fill(d, i);
}

// kernel 7 before: one thread a query, every known point, dense tiles
__global__ void __launch_bounds__(kNNThreads)
old_three_nn_kernel(const float* __restrict__ unknown,
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

// The block rank scan of kernels 6w, 5 and 10 before: all kThreads
// threads of a block scan the points [lo, hi) in ascending index, kThreads
// at a time; member(i) says whether point i belongs. A warp ballot plus
// per-warp counts in shared memory (`warp_cnt`, kThreads / 32 ints) rank
// each member, and the first k members' indices land in members[0, k).
// Returns, in every thread, the number of members in [lo, hi): the scan
// never stops early, since callers need the count.
template <int kThreads, class Member>
__device__ __forceinline__ int block_rank_scan(int lo, int hi, Member member,
                                               int k, int* members,
                                               int* warp_cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int running = 0;
  for (int base = lo; base < hi; base += kThreads) {
    const int i = base + tid;
    const bool in = i < hi && member(i);
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int wc = warp_cnt[w];
      before += w < warp ? wc : 0;
      total += wc;
    }
    const int rank = running + before + __popc(m & ((1u << lane) - 1u));
    if (in && rank < k) members[rank] = i;
    running += total;
    __syncthreads();
  }
  return running;
}

// kernels 5 and 10 before: one block of 256 threads a centre ranks all N
// points (kernel 10: the points of the z window thread 0 found by serial
// binary searches)
__global__ void __launch_bounds__(256)
old_crop_gather_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ ch,
                       const float* __restrict__ centers, int B, int N,
                       int Cc, int M, int k, float r2, int grouped,
                       int z_window, float* __restrict__ out,
                       int* __restrict__ cnt_out) {
  extern __shared__ int members[];  // k ints
  __shared__ int warp_cnt[8];
  __shared__ int s_range[2];
  const int b = blockIdx.x / M, c = blockIdx.x % M;
  const int tid = threadIdx.x;
  const float* pb = xyz + (size_t)b * N * 3;
  const float cx = centers[((size_t)b * M + c) * 2];
  const float cz = centers[((size_t)b * M + c) * 2 + 1];
  int lo = 0, hi = N;
  if (z_window > 0) {
    if (tid == 0) {
      auto near_z = [&](int j) {
        const float dz = cz - pb[3 * j + 2];
        return __fmul_rn(dz, dz) < r2;
      };
      int a = 0, e = N;
      while (a < e) {
        const int mid = (a + e) >> 1;
        if (pb[3 * mid + 2] < cz) a = mid + 1;
        else e = mid;
      }
      const int home = a;
      a = 0;
      e = home;
      while (a < e) {
        const int mid = (a + e) >> 1;
        if (near_z(mid)) e = mid;
        else a = mid + 1;
      }
      const int wlo = a;
      a = home;
      e = N;
      while (a < e) {
        const int mid = (a + e) >> 1;
        if (near_z(mid)) a = mid + 1;
        else e = mid;
      }
      const int whi = a;
      const int tiles = whi > wlo ? (whi - 1) / 128 - wlo / 128 + 1 : 0;
      s_range[0] = tiles <= z_window ? wlo : 0;
      s_range[1] = tiles <= z_window ? whi : N;
    }
    __syncthreads();
    lo = s_range[0];
    hi = s_range[1];
  }
  const int cnt = block_rank_scan<256>(
      lo, hi,
      [&](int i) { return sqdist2(cx - pb[3 * i], cz - pb[3 * i + 2]) < r2; },
      k, members, warp_cnt);
  if (tid == 0) cnt_out[(size_t)b * M + c] = cnt;
  const int Q = cnt > 0 ? k / cnt : 0, R = cnt > 0 ? k % cnt : 0;
  const int thresh = R * (Q + 1);
  const size_t plane = (size_t)B * M * k;
  float* ob = out + ((size_t)b * M + c) * k;
  for (int s = tid; s < k; s += 256) {
    if (cnt == 0) {
      for (int cc = 0; cc < Cc; ++cc) ob[cc * plane + s] = 0.f;
      continue;
    }
    int j;
    if (cnt >= k) j = s;
    else if (grouped) j = s < thresh ? s / (Q + 1) : R + (s - thresh) / Q;
    else j = s % cnt;
    const int p = members[j];
    for (int cc = 0; cc < Cc; ++cc)
      ob[cc * plane + s] = ch[((size_t)b * Cc + cc) * N + p];
  }
}

// kernel 6w before: one block of 256 threads a centre ranks all N points
__global__ void __launch_bounds__(256)
old_ball_query_wrap_kernel(const float* __restrict__ xyz,
                           const float* __restrict__ new_xyz, int N, int M,
                           BallScales sc, WrapOut o) {
  extern __shared__ int members[];  // max S_i ints
  __shared__ int warp_cnt[8];
  const int q = blockIdx.x;  // (b, m) flattened
  const float* pb = xyz + (size_t)(q / M) * N * 3;
  const float qx = new_xyz[3 * (size_t)q], qy = new_xyz[3 * (size_t)q + 1],
              qz = new_xyz[3 * (size_t)q + 2];
  for (int s = 0; s < sc.n; ++s) {
    const float r2 = sc.r2[s];
    const int S = sc.S[s];
    const int cnt = block_rank_scan<256>(
        0, N,
        [&](int i) {
          return sqdist3(qx - pb[3 * i], qy - pb[3 * i + 1],
                         qz - pb[3 * i + 2]) < r2;
        },
        S, members, warp_cnt);
    int* dst = o.idx[s] + (size_t)q * S;
    for (int k = threadIdx.x; k < S; k += 256)
      dst[k] = cnt > 0 ? members[k % cnt] : 0;
    if (threadIdx.x == 0) o.cnt[s][q] = cnt;
    __syncthreads();  // the next scale reuses `members`
  }
}

constexpr int kRingWarps = 8;

// z as an int in the same order, NaN last: (key, index) orders any centres.
__device__ __forceinline__ int z_key(float z) {
  if (z != z) return 0x7fffffff;
  const int i = __float_as_int(z);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// Kernel 6w on the staged ring of search.cuh (the other design the bench
// weighs): a block of kRingWarps warps takes kCPB
// centres of one batch row, kRingWarps / kCPB warps a centre; with kCPB > 1
// they are the row's centres of ranks blockIdx * kCPB ... in (z, index)
// order, so a block's centres are z neighbours. For each scale, warp 0
// stages the chunks, in ascending index, whose z term from the block's
// centre z range is below r2, and a centre tests a staged chunk only where
// its own z term is below r2. The warps of a centre take the chunks of
// each tile in turn and rank their members after a barrier by the counts
// of the tile's earlier chunks.
template <int kCPB>
__global__ void __launch_bounds__(kRingWarps * 32)
ring_wrap_kernel(const float* __restrict__ xyz,
                 const float* __restrict__ new_xyz,
                 const float2* __restrict__ bounds, int N, int M,
                 BallScales sc, WrapOut o, int max_s, int a16) {
  constexpr int kGW = kRingWarps / kCPB;    // warps a centre
  constexpr int kMine = kTileChunks / kGW;  // a warp's chunks of a tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const TileRing ring = ring_at(smem);
  int* members = reinterpret_cast<int*>(smem + kRingFloats);
  __shared__ int s_cnt[kCPB][kTileChunks];  // members of each staged chunk
  __shared__ int s_q[kCPB];                 // the block's centres, or -1
  const int groups = (M + kCPB - 1) / kCPB;
  const int b = blockIdx.x / groups, r0 = (blockIdx.x % groups) * kCPB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / kGW, gw = warp % kGW;
  const unsigned below = (1u << lane) - 1u;
  const float inf = __int_as_float(0x7f800000);
  const float* pb = xyz + (size_t)b * N * 3;
  const float* qb = new_xyz + (size_t)b * M * 3;
  const float2* bb = bounds + (size_t)b * n_chunks(N);
  if (kCPB == 1) {
    if (threadIdx.x == 0) s_q[0] = r0;
  } else {
    if (threadIdx.x < kCPB) s_q[threadIdx.x] = -1;
    __syncthreads();
    for (int c = threadIdx.x; c < M; c += blockDim.x) {
      const int kc = z_key(qb[3 * c + 2]);
      int rank = 0;
      for (int j = 0; j < M; ++j) {
        const int kj = z_key(qb[3 * j + 2]);
        rank += kj < kc || (kj == kc && j < c);
      }
      if (rank >= r0 && rank < r0 + kCPB) s_q[rank - r0] = c;
    }
  }
  __syncthreads();
  const int q = s_q[grp];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q >= 0) {
    qx = qb[3 * q];
    qy = qb[3 * q + 1];
    qz = qb[3 * q + 2];
  }
  float zlo = inf, zhi = -inf;  // the block's centre z range, NaN left out
  for (int g = 0; g < kCPB; ++g) {
    if (s_q[g] >= 0) {
      zlo = fminf(zlo, qb[3 * s_q[g] + 2]);
      zhi = fmaxf(zhi, qb[3 * s_q[g] + 2]);
    }
  }
  const int nch = n_chunks(N);
  const auto order = [](int p) { return p; };
  int* mem = members + grp * max_s;
  for (int s = 0; s < sc.n; ++s) {
    const float r2 = sc.r2[s];
    const int S = sc.S[s];
    const auto need = [=](float2 zb) {
      return zterm_hull(zlo, zhi, zb) < r2;
    };
    int running = 0;  // the centre's members so far, in each of its warps
    int pos = 0;      // warp 0's cursor
    if (warp == 0)
      for (int t = 0; t < kStages - 1; ++t)
        ring_stage(pb, N, bb, a16 != 0, nch, order, need, pos, ring, t);
    for (int t = 0;; ++t) {
      if (warp == 0) ring_wait();
      __syncthreads();
      const int slot = t % kStages;
      const int nc = ring.cnt[slot];
      if (nc == 0) break;  // block-uniform
      if (warp == 0)
        ring_stage(pb, N, bb, a16 != 0, nch, order, need, pos, ring,
                   (t + kStages - 1) % kStages);
      const float* tp = ring.pts + slot * kTileChunks * 3 * kChunk;
      const int* cid = ring.cid + slot * kTileChunks;
      unsigned hit[kMine];
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int k = gw + i * kGW;
        hit[i] = 0u;
        if (k < nc) {  // warp-uniform
          if (q >= 0 && zterm(qz, ring.zb[slot * kTileChunks + k]) < r2) {
            const int j = cid[k] * kChunk + lane;
            const float* p = tp + 3 * kChunk * k + 3 * lane;
            hit[i] = __ballot_sync(
                0xffffffffu,
                j < N && sqdist3(qx - p[0], qy - p[1], qz - p[2]) < r2);
          }
          if (lane == 0) s_cnt[grp][k] = __popc(hit[i]);
        }
      }
      __syncthreads();
      // lane l: the centre's members in the tile's chunks before l
      const int c = lane < nc ? s_cnt[grp][lane] : 0;
      int incl = c;
#pragma unroll
      for (int o2 = 1; o2 < 32; o2 <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o2);
        if (lane >= o2) incl += v;
      }
      const int excl = incl - c;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int k = gw + i * kGW;
        const int rank = running + __shfl_sync(0xffffffffu, excl, k) +
                         __popc(hit[i] & below);
        if ((hit[i] >> lane & 1u) && rank < S)
          mem[rank] = cid[k] * kChunk + lane;
      }
      running += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (warp == 0) ring_drain();
    __syncthreads();
    if (q >= 0) {
      int* dst = o.idx[s] + ((size_t)b * M + q) * S;
      for (int k = gw * 32 + lane; k < S; k += kGW * 32)
        dst[k] = running > 0 ? mem[k % running] : 0;
      if (gw == 0 && lane == 0) o.cnt[s][(size_t)b * M + q] = running;
    }
    __syncthreads();  // the next scale reuses the ring and `members`
  }
}

// Launches the ring variant with kCPB centres a block after the pre-pass.
template <int kCPB>
int launch_ring_wrap(const float* xyz, const float* new_xyz, int B, int N,
                     int M, const BallScales& sc, const WrapOut& o, int max_s,
                     float2* bounds, cudaStream_t st) {
  const size_t smem = sizeof(float) * kRingFloats +
                      sizeof(int) * (size_t)kCPB * max_s;
  if (smem + sizeof(int) * kCPB * (kTileChunks + 1) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  int err = ws3d_set_smem((const void*)ring_wrap_kernel<kCPB>, smem);
  if (!err) err = launch_chunk_bounds(xyz, B, N, bounds, st);
  if (err) return err;
  const int a16 =
      (reinterpret_cast<uintptr_t>(xyz) & 15) == 0 && N % 4 == 0 ? 1 : 0;
  const long long grid = (long long)B * ((M + kCPB - 1) / kCPB);
  ring_wrap_kernel<kCPB><<<(unsigned)grid, kRingWarps * 32, smem, st>>>(
      xyz, new_xyz, bounds, N, M, sc, o, max_s, a16);
  return (int)cudaGetLastError();
}

// kernel 4 before: one thread a query, every known point, dense tiles
__global__ void __launch_bounds__(kNNThreads)
old_three_interp_kernel(const float* __restrict__ unknown,
                        const float* __restrict__ known,
                        const float* __restrict__ feats, int n, int m, int C,
                        float* __restrict__ out) {
  __shared__ float tile[3 * kNNTile];
  __shared__ int s_idx[kNNThreads][3];
  __shared__ float s_w[kNNThreads][3];
  const int tiles = (n + kNNThreads - 1) / kNNThreads;
  const int b = blockIdx.x / tiles;
  const int u0 = (blockIdx.x % tiles) * kNNThreads;
  const int tid = threadIdx.x;
  const int u = u0 + tid;
  const float* ub = unknown + (size_t)b * n * 3;
  const float* fb = feats + (size_t)b * m * C;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (u < n) {
    qx = ub[3 * u];
    qy = ub[3 * u + 1];
    qz = ub[3 * u + 2];
  }
  float d[3];
  int nn[3];
  block_three_nn(known + (size_t)b * m * 3, m, qx, qy, qz, tile, d, nn);
  const float r0 = 1.0f / (d[0] + 1e-8f), r1 = 1.0f / (d[1] + 1e-8f),
              r2 = 1.0f / (d[2] + 1e-8f);
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  for (int k = 0; k < 3; ++k) s_idx[tid][k] = nn[k];
  s_w[tid][0] = r0 / norm;
  s_w[tid][1] = r1 / norm;
  s_w[tid][2] = r2 / norm;
  __syncthreads();
  const int nu = min(kNNThreads, n - u0);
  for (int t = tid; t < nu * C; t += kNNThreads) {
    const int q = t / C, c = t - q * C;
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(fb[(size_t)s_idx[q][0] * C + c], s_w[q][0]),
                  __fmul_rn(fb[(size_t)s_idx[q][1] * C + c], s_w[q][1])),
        __fmul_rn(fb[(size_t)s_idx[q][2] * C + c], s_w[q][2]));
    out[((size_t)b * n + u0 + q) * C + c] = v;
  }
}

// kernel 8 before: one thread a query, a serial binary search for the
// query's home in the known z, then a walk outward to the side whose next
// point is nearer in z, until both sides' next z term exceeds the
// third-best d2 (exact on z-sorted clouds)
__global__ void __launch_bounds__(kNNThreads)
old_three_interp_window_kernel(const float* __restrict__ unknown,
                               const float* __restrict__ known,
                               const float* __restrict__ feats, int n, int m,
                               int C, float* __restrict__ out,
                               int* __restrict__ idx_out,
                               float* __restrict__ d2_out) {
  __shared__ int s_idx[kNNThreads][3];
  __shared__ float s_w[kNNThreads][3];
  const int tiles = (n + kNNThreads - 1) / kNNThreads;
  const int b = blockIdx.x / tiles;
  const int u0 = (blockIdx.x % tiles) * kNNThreads;
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
    const size_t o = ((size_t)b * n + u) * 3;
    for (int t = 0; t < 3; ++t) {
      idx_out[o + t] = nn[t];
      d2_out[o + t] = d[t];
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
  const int nu = min(kNNThreads, n - u0);
  for (int t = tid; t < nu * C; t += kNNThreads) {
    const int q = t / C, c = t - q * C;
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(fb[(size_t)s_idx[q][0] * C + c], s_w[q][0]),
                  __fmul_rn(fb[(size_t)s_idx[q][1] * C + c], s_w[q][1])),
        __fmul_rn(fb[(size_t)s_idx[q][2] * C + c], s_w[q][2]));
    out[((size_t)b * n + u0 + q) * C + c] = v;
  }
}

// the crop-gather's arguments, and each sizing the bench tries
struct CropArgs {
  const float *xyz, *ch, *centers;
  int B, N, C, M, k;
  float r2;
  float2* bounds;
};

template <int kW, int kU>
int crop_sizing(const CropArgs& a, int z_window, float* out, int* cnt) {
  return launch_crop_gather<kW, kU>(a.xyz, a.ch, a.centers, a.B, a.N, a.C,
                                    a.M, a.k, a.r2, 1, z_window, out, cnt,
                                    a.bounds, nullptr);
}

const struct {
  const char* name;
  int (*launch)(const CropArgs&, int, float*, int*);
} kCropSizings[] = {
    {"4w 2c", crop_sizing<4, 2>},   {"4w 4c", crop_sizing<4, 4>},
    {"4w 8c", crop_sizing<4, 8>},   {"8w 2c", crop_sizing<8, 2>},
    {"8w 4c", crop_sizing<8, 4>},   {"8w 8c", crop_sizing<8, 8>},
    {"16w 2c", crop_sizing<16, 2>}, {"16w 4c", crop_sizing<16, 4>},
    {"16w 8c", crop_sizing<16, 8>},
};

struct BQShape {
  const char* name;
  bool crop;
  int B, N, M, n_scales;
  float radius[2];
  int S[2];
};

const BQShape kBQShapes[] = {
    {"stage-1 SA0", false, 16, 16384, 4096, 2, {0.1f, 0.5f}, {16, 32}},
    {"stage-1 SA1", false, 16, 4096, 1024, 2, {0.5f, 1.0f}, {16, 32}},
    {"stage-1 SA2", false, 16, 1024, 256, 2, {1.0f, 2.0f}, {16, 32}},
    {"stage-1 SA3", false, 16, 256, 64, 2, {2.0f, 4.0f}, {16, 32}},
    {"RCNN SA0", true, 800, 512, 256, 1, {0.2f, 0.f}, {16, 0}},
    {"RCNN SA1", true, 800, 256, 128, 1, {0.4f, 0.f}, {32, 0}},
    {"RCNN SA2", true, 800, 128, 32, 1, {1.0f, 0.f}, {64, 0}},
};

struct FPShape {
  const char* name;
  int B, n, m, C;
};

const FPShape kFPShapes[] = {
    {"inference FP3", 16, 256, 64, 512},
    {"inference FP2", 16, 1024, 256, 512},
    {"inference FP1", 16, 4096, 1024, 256},
    {"inference FP0", 16, 16384, 4096, 128},
    {"database FP0", 1, 16384, 4096, 128},
};

struct NNShape {
  const char* name;
  int B, n, m;
};

const NNShape kNNShapes[] = {
    {"stage-1 FP3", 16, 256, 64},
    {"stage-1 FP2", 16, 1024, 256},
    {"stage-1 FP1", 16, 4096, 1024},
    {"stage-1 FP0", 16, 16384, 4096},
};

// B rows of N LiDAR-like points sorted by z
std::vector<float> cloud(std::mt19937& gen, int B, int N, bool crop) {
  std::uniform_real_distribution<float> u(0.f, 1.f);
  std::normal_distribution<float> g(0.f, 1.f);
  std::vector<float> xyz((size_t)B * N * 3);
  std::vector<std::array<float, 3>> pts(N);
  for (int b = 0; b < B; ++b) {
    const float cz = crop ? 5.f + 60.f * u(gen) : 0.f;
    for (auto& p : pts) {
      float x, z;
      if (crop) {
        const float a = 6.2831853f * u(gen), r = 4.f * std::sqrt(u(gen));
        x = r * std::cos(a);
        z = cz + r * std::sin(a);
      } else {
        z = 70.f * u(gen) * u(gen) + 2.f;
        x = (u(gen) - 0.5f) * (0.2f + 1.4f * z);
      }
      const float y = u(gen) < 0.6f ? 1.7f + 0.05f * g(gen)
                                    : 1.7f - 2.f * u(gen);
      p = {x, y, z};
    }
    std::sort(pts.begin(), pts.end(),
              [](const auto& a, const auto& c) { return a[2] < c[2]; });
    for (int j = 0; j < N; ++j)
      for (int c = 0; c < 3; ++c) xyz[((size_t)b * N + j) * 3 + c] = pts[j][c];
  }
  return xyz;
}

// every (N / M)-th point of each row
std::vector<float> every(const std::vector<float>& xyz, int B, int N, int M) {
  std::vector<float> q((size_t)B * M * 3);
  for (int b = 0; b < B; ++b)
    for (int m = 0; m < M; ++m)
      for (int c = 0; c < 3; ++c)
        q[((size_t)b * M + m) * 3 + c] =
            xyz[((size_t)b * N + (size_t)m * (N / M)) * 3 + c];
  return q;
}

// each row's rows of `width` floats in a random order (the same order for
// `other`, if given)
void shuffle_rows(std::mt19937& gen, std::vector<float>& v, int B, int N,
                  int width, std::vector<float>* other = nullptr,
                  int owidth = 0) {
  std::vector<int> perm(N);
  for (int b = 0; b < B; ++b) {
    std::iota(perm.begin(), perm.end(), 0);
    std::shuffle(perm.begin(), perm.end(), gen);
    auto apply = [&](std::vector<float>& a, int w) {
      std::vector<float> row(a.begin() + (size_t)b * N * w,
                             a.begin() + (size_t)(b + 1) * N * w);
      for (int j = 0; j < N; ++j)
        std::memcpy(&a[((size_t)b * N + j) * w], &row[(size_t)perm[j] * w],
                    w * sizeof(float));
    };
    apply(v, width);
    if (other) apply(*other, owidth);
  }
}

template <class T>
T* to_device(const std::vector<T>& h) {
  T* p;
  CHECK(cudaMalloc(&p, h.size() * sizeof(T)));
  CHECK(cudaMemcpy(p, h.data(), h.size() * sizeof(T),
                   cudaMemcpyHostToDevice));
  return p;
}

template <class F>
float time_ms(F launch, cudaEvent_t e0, cudaEvent_t e1) {
  CHECK(launch());
  CHECK(cudaEventRecord(e0));
  for (int k = 0; k < 5; ++k) CHECK(launch());
  CHECK(cudaEventRecord(e1));
  CHECK(cudaEventSynchronize(e1));
  float ms = 0.f;
  CHECK(cudaEventElapsedTime(&ms, e0, e1));
  return ms / 5;
}

// row 0's first scale on the host, in the kernels' arithmetic
bool host_row0_ok(const std::vector<float>& xyz, const std::vector<float>& q,
                  const BQShape& s, float r2, const std::vector<int>& got) {
  const int S = s.S[0];
  for (int m = 0; m < s.M; ++m) {
    std::vector<int> hit;
    for (int j = 0; j < s.N && (int)hit.size() < S; ++j) {
      const float dx = q[3 * m] - xyz[3 * j];
      const float dy = q[3 * m + 1] - xyz[3 * j + 1];
      const float dz = q[3 * m + 2] - xyz[3 * j + 2];
      if ((dx * dx + dy * dy) + dz * dz < r2) hit.push_back(j);
    }
    for (int k = 0; k < S; ++k) {
      const int want = k < (int)hit.size() ? hit[k] : hit.empty() ? 0 : hit[0];
      if (got[(size_t)m * S + k] != want) return false;
    }
  }
  return true;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::mt19937 gen(0);
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  bool ok = true;

  for (const BQShape& s : kBQShapes) {
    std::vector<float> xyz = cloud(gen, s.B, s.N, s.crop);
    std::vector<float> q = every(xyz, s.B, s.N, s.M);
    for (int order = 0; order < 2; ++order) {
      if (order == 1) {
        shuffle_rows(gen, xyz, s.B, s.N, 3);
        shuffle_rows(gen, q, s.B, s.M, 3);
      }
      float* dxyz = to_device(xyz);
      float* dq = to_device(q);
      float r2[2];
      int* dout[2][2];
      BQOut o{};
      BallScales sc{};
      sc.n = s.n_scales;
      int row_len = 0;
      for (int k = 0; k < s.n_scales; ++k) {
        r2[k] = (float)((double)s.radius[k] * s.radius[k]);
        sc.r2[k] = r2[k];
        sc.S[k] = s.S[k];
        row_len += s.S[k];
        for (int v = 0; v < 2; ++v)
          CHECK(cudaMalloc(&dout[v][k], (size_t)s.B * s.M * s.S[k] * 4));
      }
      float2* dbounds;
      CHECK(cudaMalloc(&dbounds, (size_t)s.B * n_chunks(s.N) * 8));
      const int BM = s.B * s.M;
      auto old_launch = [&] {
        for (int k = 0; k < s.n_scales; ++k) o.out[k] = dout[0][k];
        old_ball_query_kernel<<<(BM + 7) / 8, 256, 8 * row_len * 4>>>(
            dxyz, dq, BM, s.N, s.M, sc, o, row_len);
        return (int)cudaGetLastError();
      };
      auto new_launch = [&] {
        void* outs[2] = {dout[1][0], dout[1][1]};
        return ws3d_ball_query(dxyz, dq, s.B, s.N, s.M, s.n_scales, r2, s.S,
                               outs, dbounds, nullptr);
      };
      auto same_as_old = [&](bool check_host) {
        bool same = true;
        for (int k = 0; k < s.n_scales; ++k) {
          const size_t cnt = (size_t)s.B * s.M * s.S[k];
          std::vector<int> a(cnt), b(cnt);
          CHECK(cudaMemcpy(a.data(), dout[0][k], cnt * 4,
                           cudaMemcpyDeviceToHost));
          CHECK(cudaMemcpy(b.data(), dout[1][k], cnt * 4,
                           cudaMemcpyDeviceToHost));
          same = same && a == b;
          if (k == 0 && check_host)
            same = same && host_row0_ok(xyz, q, s, r2[0], b);
        }
        return same;
      };
      const float t_old = time_ms(old_launch, e0, e1);
      const float t_new = time_ms(new_launch, e0, e1);
      const bool same = same_as_old(true);
      for (int k = 0; k < s.n_scales; ++k)
        CHECK(cudaMemset(dout[1][k], 0xff, (size_t)s.B * s.M * s.S[k] * 4));
      // the kept 2 queries a warp against 1 and 4
      BQOut o2{};
      for (int k = 0; k < s.n_scales; ++k) o2.out[k] = dout[1][k];
      const float t_q1 = time_ms([&] {
        return launch_ball_query<1>(dxyz, dq, s.B, s.N, s.M, sc, o2, row_len,
                                    dbounds, nullptr);
      }, e0, e1);
      const bool same1 = same_as_old(false);
      for (int k = 0; k < s.n_scales; ++k)
        CHECK(cudaMemset(dout[1][k], 0xff, (size_t)s.B * s.M * s.S[k] * 4));
      const float t_q4 = time_ms([&] {
        return launch_ball_query<4>(dxyz, dq, s.B, s.N, s.M, sc, o2, row_len,
                                    dbounds, nullptr);
      }, e0, e1);
      const bool same4 = same_as_old(false);
      std::printf("kernel 6 %s B%d N%d M%d %s: old %.4f ms, new %.4f ms "
                  "(%.2fx; queries a warp: 1 %.4f ms, 4 %.4f ms)%s%s\n",
                  s.name, s.B, s.N, s.M, order ? "shuffled" : "sorted", t_old,
                  t_new, t_old / t_new, t_q1, t_q4,
                  same ? "" : " FAIL: new != old or row 0 != host",
                  same1 && same4 ? "" : " FAIL: a sizing != old");
      ok = ok && same && same1 && same4;
      for (int k = 0; k < s.n_scales; ++k)
        for (int v = 0; v < 2; ++v) CHECK(cudaFree(dout[v][k]));
      for (void* p : {(void*)dxyz, (void*)dq, (void*)dbounds})
        CHECK(cudaFree(p));
    }
  }

  for (const FPShape& s : kFPShapes) {
    std::vector<float> un = cloud(gen, s.B, s.n, false);
    std::vector<float> kn = every(un, s.B, s.n, s.m);
    std::uniform_real_distribution<float> u(-1.f, 1.f);
    std::vector<float> feat((size_t)s.B * s.m * s.C);
    for (float& v : feat) v = u(gen);
    for (int order = 0; order < 2; ++order) {
      if (order == 1) {
        shuffle_rows(gen, un, s.B, s.n, 3);
        shuffle_rows(gen, kn, s.B, s.m, 3, &feat, s.C);
      }
      float* du = to_device(un);
      float* dk = to_device(kn);
      float* df = to_device(feat);
      const size_t n_out = (size_t)s.B * s.n * s.C;
      float *dold, *dnew;
      float2* dbounds;
      CHECK(cudaMalloc(&dold, n_out * 4));
      CHECK(cudaMalloc(&dnew, n_out * 4));
      CHECK(cudaMalloc(&dbounds, (size_t)s.B * n_chunks(s.m) * 8));
      auto old_launch = [&] {
        old_three_interp_kernel<<<s.B * ((s.n + kNNThreads - 1) / kNNThreads),
                                  kNNThreads>>>(du, dk, df, s.n, s.m, s.C,
                                                dold);
        return (int)cudaGetLastError();
      };
      auto new_launch = [&] {
        return ws3d_three_interpolate(du, dk, df, s.B, s.n, s.m, s.C, dnew,
                                      dbounds, nullptr);
      };
      const float t_old = time_ms(old_launch, e0, e1);
      const float t_new = time_ms(new_launch, e0, e1);
      std::vector<float> a(n_out), b(n_out);
      CHECK(cudaMemcpy(a.data(), dold, n_out * 4, cudaMemcpyDeviceToHost));
      auto same_as_old = [&] {
        CHECK(cudaMemcpy(b.data(), dnew, n_out * 4, cudaMemcpyDeviceToHost));
        return std::memcmp(a.data(), b.data(), n_out * 4) == 0;
      };
      bool same = same_as_old();
      const int sms = prop.multiProcessorCount;
      std::printf("kernel 4 %s B%d n%d m%d C%d %s: old %.4f ms, new %.4f ms "
                  "(%.2fx; %d channel groups",
                  s.name, s.B, s.n, s.m, s.C, order ? "shuffled" : "sorted",
                  t_old, t_new, t_old / t_new,
                  three_interp_splits(1, s.B, s.n, s.m, s.C, sms));
      // the kept sizing against other launch bounds and queries a thread
      auto variant = [&](const char* name, int v, auto launch) {
        const int cs = three_interp_splits(v, s.B, s.n, s.m, s.C, sms);
        CHECK(cudaMemset(dnew, 0xff, n_out * 4));
        const float tv = time_ms([&] { return launch(cs); }, e0, e1);
        const bool sv = same_as_old();
        same = same && sv;
        std::printf("; %s %.4f ms%s", name, tv, sv ? "" : " FAIL");
      };
      variant("4 blocks an SM", 1, [&](int cs) {
        return launch_three_interp<1, 4>(cs, du, dk, df, s.B, s.n, s.m, s.C,
                                         dnew, dbounds, nullptr);
      });
      variant("12 blocks an SM", 1, [&](int cs) {
        return launch_three_interp<1, 12>(cs, du, dk, df, s.B, s.n, s.m,
                                          s.C, dnew, dbounds, nullptr);
      });
      variant("2 queries a thread", 2, [&](int cs) {
        return launch_three_interp<2, 4>(cs, du, dk, df, s.B, s.n, s.m, s.C,
                                         dnew, dbounds, nullptr);
      });
      variant("4 queries a thread", 4, [&](int cs) {
        return launch_three_interp<4, 4>(cs, du, dk, df, s.B, s.n, s.m, s.C,
                                         dnew, dbounds, nullptr);
      });
      std::printf(")%s\n", same ? "" : " FAIL: new != old");
      ok = ok && same;
      for (void* p : {(void*)du, (void*)dk, (void*)df, (void*)dold,
                      (void*)dnew, (void*)dbounds})
        CHECK(cudaFree(p));
    }
  }
  // kernel 8 on the sorted FP shapes: the ring walk it was against its
  // launch as the library makes it, (b) on each sorted chunk's first and
  // last z read in place (SortedChunkEnds: no pre-pass, no workspace), and
  // against kernel 4's launch with the neighbours written out, (a) with
  // kernel 4's pre-pass, and (b0) without it on chunk bounds written once
  // (what (b) would take if its in-place reads cost nothing). Four rounds
  // of each, in turns, give each its spread; every round's output must
  // equal the old one.
  for (const FPShape& s : kFPShapes) {
    std::vector<float> un = cloud(gen, s.B, s.n, false);
    std::vector<float> kn = every(un, s.B, s.n, s.m);
    std::uniform_real_distribution<float> u(-1.f, 1.f);
    std::vector<float> feat((size_t)s.B * s.m * s.C);
    for (float& v : feat) v = u(gen);
    float* du = to_device(un);
    float* dk = to_device(kn);
    float* df = to_device(feat);
    const size_t n_out = (size_t)s.B * s.n * s.C, n_nn = (size_t)s.B * s.n * 3;
    float *dout[2], *dd2[2];
    int* didx[2];
    for (int v = 0; v < 2; ++v) {
      CHECK(cudaMalloc(&dout[v], n_out * 4));
      CHECK(cudaMalloc(&dd2[v], n_nn * 4));
      CHECK(cudaMalloc(&didx[v], n_nn * 4));
    }
    float2* dbounds;
    CHECK(cudaMalloc(&dbounds, (size_t)s.B * n_chunks(s.m) * 8));
    const int cs = three_interp_splits(1, s.B, s.n, s.m, s.C,
                                       prop.multiProcessorCount);
    const int a16 = s.m % 4 == 0 ? 1 : 0;  // cudaMalloc aligns
    const unsigned grid =
        (unsigned)((long long)s.B * ((s.n + kQ - 1) / kQ) * cs);
    const float t_old = time_ms([&] {
      old_three_interp_window_kernel<<<s.B * ((s.n + kNNThreads - 1) /
                                              kNNThreads),
                                       kNNThreads>>>(du, dk, df, s.n, s.m,
                                                     s.C, dout[0], didx[0],
                                                     dd2[0]);
      return (int)cudaGetLastError();
    }, e0, e1);
    auto with_prepass = [&] {
      return launch_three_interp<1, kInterpMinBlocks>(
          cs, du, dk, df, s.B, s.n, s.m, s.C, dout[1], dbounds, nullptr,
          didx[1], dd2[1]);
    };
    auto without_prepass = [&] {
      three_interp_kernel<1, kInterpMinBlocks><<<grid, kQ>>>(
          du, dk, dbounds, df, s.n, s.m, s.C, cs, a16, dout[1], didx[1],
          dd2[1]);
      return (int)cudaGetLastError();
    };
    auto sorted_ends = [&] {
      return ws3d_three_interpolate_window(du, dk, df, s.B, s.n, s.m, s.C,
                                           dout[1], didx[1], dd2[1], nullptr);
    };
    auto same_as_old = [&] {
      std::vector<float> a(n_out), b(n_out), ad(n_nn), bd(n_nn);
      std::vector<int> ai(n_nn), bi(n_nn);
      CHECK(cudaMemcpy(a.data(), dout[0], n_out * 4, cudaMemcpyDeviceToHost));
      CHECK(cudaMemcpy(b.data(), dout[1], n_out * 4, cudaMemcpyDeviceToHost));
      CHECK(cudaMemcpy(ad.data(), dd2[0], n_nn * 4, cudaMemcpyDeviceToHost));
      CHECK(cudaMemcpy(bd.data(), dd2[1], n_nn * 4, cudaMemcpyDeviceToHost));
      CHECK(cudaMemcpy(ai.data(), didx[0], n_nn * 4, cudaMemcpyDeviceToHost));
      CHECK(cudaMemcpy(bi.data(), didx[1], n_nn * 4, cudaMemcpyDeviceToHost));
      return std::memcmp(a.data(), b.data(), n_out * 4) == 0 &&
             std::memcmp(ad.data(), bd.data(), n_nn * 4) == 0 && ai == bi;
    };
    // (a), (b), (b0) in turns: a b b0 b0 b a, twice
    float t[3][4];
    bool same = true;
    for (int r = 0; r < 2; ++r) {
      int k = 0;
      for (int v : {0, 1, 2, 2, 1, 0}) {
        CHECK(cudaMemset(dout[1], 0xff, n_out * 4));
        t[v][2 * r + (k++ >= 3)] =
            time_ms(v == 0 ? std::function<int()>(with_prepass)
                    : v == 1 ? std::function<int()>(sorted_ends)
                             : std::function<int()>(without_prepass),
                    e0, e1);
        same = same && same_as_old();
      }
    }
    std::printf("kernel 8 %s B%d n%d m%d C%d sorted: old %.4f ms; new (b, "
                "each chunk's first and last z) %.4f %.4f %.4f %.4f ms "
                "(%.2fx); kernel 4's launch (a, its pre-pass) %.4f %.4f %.4f "
                "%.4f ms, (b0, bounds written once) %.4f %.4f %.4f %.4f "
                "ms%s\n",
                s.name, s.B, s.n, s.m, s.C, t_old, t[1][0], t[1][1], t[1][2],
                t[1][3], t_old / *std::min_element(t[1], t[1] + 4), t[0][0],
                t[0][1], t[0][2], t[0][3], t[2][0], t[2][1], t[2][2], t[2][3],
                same ? "" : " FAIL: new != old");
    ok = ok && same;
    for (int v = 0; v < 2; ++v)
      for (void* p : {(void*)dout[v], (void*)dd2[v], (void*)didx[v]})
        CHECK(cudaFree(p));
    for (void* p : {(void*)du, (void*)dk, (void*)df, (void*)dbounds})
      CHECK(cudaFree(p));
  }
  for (const NNShape& s : kNNShapes) {
    std::vector<float> un = cloud(gen, s.B, s.n, false);
    std::vector<float> kn = every(un, s.B, s.n, s.m);
    for (int order = 0; order < 2; ++order) {
      if (order == 1) {
        shuffle_rows(gen, un, s.B, s.n, 3);
        shuffle_rows(gen, kn, s.B, s.m, 3);
      }
      float* du = to_device(un);
      float* dk = to_device(kn);
      const size_t n_out = (size_t)s.B * s.n * 3;
      float *dd_old, *dd_new;
      int *di_old, *di_new;
      float2* dbounds;
      CHECK(cudaMalloc(&dd_old, n_out * 4));
      CHECK(cudaMalloc(&dd_new, n_out * 4));
      CHECK(cudaMalloc(&di_old, n_out * 4));
      CHECK(cudaMalloc(&di_new, n_out * 4));
      CHECK(cudaMalloc(&dbounds, (size_t)s.B * n_chunks(s.m) * 8));
      const float t_old = time_ms([&] {
        old_three_nn_kernel<<<s.B * ((s.n + kNNThreads - 1) / kNNThreads),
                              kNNThreads>>>(du, dk, s.n, s.m, dd_old, di_old);
        return (int)cudaGetLastError();
      }, e0, e1);
      const float t_new = time_ms([&] {
        return ws3d_three_nn(du, dk, s.B, s.n, s.m, dd_new, di_new, dbounds, 1,
                             nullptr);
      }, e0, e1);
      std::vector<float> a(n_out), b(n_out);
      std::vector<int> ai(n_out), bi(n_out);
      CHECK(cudaMemcpy(a.data(), dd_old, n_out * 4, cudaMemcpyDeviceToHost));
      CHECK(cudaMemcpy(ai.data(), di_old, n_out * 4, cudaMemcpyDeviceToHost));
      auto same_as_old = [&] {
        CHECK(cudaMemcpy(b.data(), dd_new, n_out * 4, cudaMemcpyDeviceToHost));
        CHECK(cudaMemcpy(bi.data(), di_new, n_out * 4, cudaMemcpyDeviceToHost));
        return std::memcmp(a.data(), b.data(), n_out * 4) == 0 && ai == bi;
      };
      bool same = same_as_old();
      std::printf("kernel 7 %s B%d n%d m%d %s: old %.4f ms, new %.4f ms "
                  "(%.2fx", s.name, s.B, s.n, s.m,
                  order ? "shuffled" : "sorted", t_old, t_new, t_old / t_new);
      // the kept sizing, and the pre-pass, against the alternatives
      auto variant = [&](const char* name, auto launch) {
        CHECK(cudaMemset(dd_new, 0xff, n_out * 4));
        CHECK(cudaMemset(di_new, 0xff, n_out * 4));
        const float tv = time_ms(launch, e0, e1);
        const bool sv = same_as_old();
        same = same && sv;
        std::printf("; %s %.4f ms%s", name, tv, sv ? "" : " FAIL");
      };
      variant("the forward's bounds (no pre-pass)", [&] {
        return ws3d_three_nn(du, dk, s.B, s.n, s.m, dd_new, di_new, dbounds, 0,
                             nullptr);
      });
      variant("4 blocks an SM", [&] {
        return launch_three_nn<1, 4>(du, dk, s.B, s.n, s.m, dd_new, di_new,
                                     dbounds, 1, nullptr);
      });
      variant("12 blocks an SM", [&] {
        return launch_three_nn<1, 12>(du, dk, s.B, s.n, s.m, dd_new, di_new,
                                      dbounds, 1, nullptr);
      });
      variant("2 queries a thread", [&] {
        return launch_three_nn<2, 4>(du, dk, s.B, s.n, s.m, dd_new, di_new,
                                     dbounds, 1, nullptr);
      });
      variant("4 queries a thread", [&] {
        return launch_three_nn<4, 4>(du, dk, s.B, s.n, s.m, dd_new, di_new,
                                     dbounds, 1, nullptr);
      });
      std::printf(")%s\n", same ? "" : " FAIL: new != old");
      ok = ok && same;
      for (void* p : {(void*)du, (void*)dk, (void*)dd_old, (void*)dd_new,
                      (void*)di_old, (void*)di_new, (void*)dbounds})
        CHECK(cudaFree(p));
    }
  }

  {  // kernel 6w at the database path's launch: one scene
    const int B = 1, N = 16384, M = 64, n_far = 3000;
    int S = 2048;
    const float radius = 4.f;
    const float r2 = (float)((double)radius * radius);
    std::vector<float> xyz = cloud(gen, B, N, false);
    for (int j = 0; j < N; ++j) {
      xyz[3 * j + 1] = 0.f;  // BEV: y zeroed on both sides
      if (j >= N - n_far) xyz[3 * j] = xyz[3 * j + 2] = 1e6f;  // invalid
    }
    std::vector<int> pick(N - n_far);
    std::iota(pick.begin(), pick.end(), 0);
    std::shuffle(pick.begin(), pick.end(), gen);  // centres in score order
    std::vector<float> q(3 * M);
    for (int c = 0; c < M; ++c)
      for (int k = 0; k < 3; ++k) q[3 * c + k] = xyz[3 * pick[c] + k];
    for (int order = 0; order < 2; ++order) {
      if (order == 1) shuffle_rows(gen, xyz, B, N, 3);
      float* dxyz = to_device(xyz);
      float* dq = to_device(q);
      int *di[2], *dc[2];
      for (int v = 0; v < 2; ++v) {
        CHECK(cudaMalloc(&di[v], (size_t)B * M * S * 4));
        CHECK(cudaMalloc(&dc[v], (size_t)B * M * 4));
      }
      float2* dbounds;
      CHECK(cudaMalloc(&dbounds, (size_t)B * n_chunks(N) * 8));
      BallScales sc{};
      sc.n = 1;
      sc.r2[0] = r2;
      sc.S[0] = S;
      WrapOut o_old{}, o_new{};
      o_old.idx[0] = di[0];
      o_old.cnt[0] = dc[0];
      o_new.idx[0] = di[1];
      o_new.cnt[0] = dc[1];
      const float t_old = time_ms([&] {
        old_ball_query_wrap_kernel<<<B * M, 256, S * 4>>>(dxyz, dq, N, M, sc,
                                                          o_old);
        return (int)cudaGetLastError();
      }, e0, e1);
      const float t_new = time_ms([&] {
        void* idx[1] = {di[1]};
        void* cnt[1] = {dc[1]};
        return ws3d_ball_query_wrap(dxyz, dq, B, N, M, 1, &r2, &S, idx, cnt,
                                    dbounds, nullptr);
      }, e0, e1);
      std::vector<int> ai((size_t)B * M * S), bi(ai.size()), ac(B * M),
          bc(B * M);
      CHECK(cudaMemcpy(ai.data(), di[0], ai.size() * 4,
                       cudaMemcpyDeviceToHost));
      CHECK(cudaMemcpy(ac.data(), dc[0], ac.size() * 4,
                       cudaMemcpyDeviceToHost));
      auto same_as_old = [&] {
        CHECK(cudaMemcpy(bi.data(), di[1], bi.size() * 4,
                         cudaMemcpyDeviceToHost));
        CHECK(cudaMemcpy(bc.data(), dc[1], bc.size() * 4,
                         cudaMemcpyDeviceToHost));
        return ai == bi && ac == bc;
      };
      bool same = same_as_old();
      long long slab = 0, members = 0;
      int over = 0;
      for (int c = 0; c < M; ++c) {
        for (int j = 0; j < N; ++j) {
          const float dz = q[3 * c + 2] - xyz[3 * j + 2];
          slab += dz * dz < r2;
        }
        members += ac[c];
        over += ac[c] > S;
      }
      std::printf("kernel 6w database B%d N%d M%d r%.0f S%d %s (%.1f slab "
                  "points and %.1f members a centre, %d centres over S): old "
                  "%.4f ms, new %.4f ms (%.2fx",
                  B, N, M, radius, S, order ? "shuffled" : "sorted",
                  (double)slab / M, (double)members / M, over, t_old, t_new,
                  t_old / t_new);
      auto variant = [&](const char* name, auto launch) {
        CHECK(cudaMemset(di[1], 0xff, bi.size() * 4));
        CHECK(cudaMemset(dc[1], 0xff, bc.size() * 4));
        const float tv = time_ms(launch, e0, e1);
        const bool sv = same_as_old();
        same = same && sv;
        std::printf("; %s %.4f ms%s", name, tv, sv ? "" : " FAIL");
      };
      // the kept sizing against other sizes, and the staged ring design
      // with one centre a block and with blocks of centres in z order
      variant("8 warps", [&] {
        return launch_ball_query_wrap<8, kWrapRound>(dxyz, dq, B, N, M, sc,
                                                     o_new, S, dbounds,
                                                     nullptr);
      });
      variant("32 warps", [&] {
        return launch_ball_query_wrap<32, kWrapRound>(dxyz, dq, B, N, M, sc,
                                                      o_new, S, dbounds,
                                                      nullptr);
      });
      variant("2 chunks a warp a round", [&] {
        return launch_ball_query_wrap<kWrapWarps, 2>(dxyz, dq, B, N, M, sc,
                                                     o_new, S, dbounds,
                                                     nullptr);
      });
      variant("8 chunks a warp a round", [&] {
        return launch_ball_query_wrap<kWrapWarps, 8>(dxyz, dq, B, N, M, sc,
                                                     o_new, S, dbounds,
                                                     nullptr);
      });
      variant("staged ring, 1 centre a block", [&] {
        return launch_ring_wrap<1>(dxyz, dq, B, N, M, sc, o_new, S, dbounds,
                                   nullptr);
      });
      variant("staged ring, 2 centres in z order", [&] {
        return launch_ring_wrap<2>(dxyz, dq, B, N, M, sc, o_new, S, dbounds,
                                   nullptr);
      });
      variant("staged ring, 8 centres in z order", [&] {
        return launch_ring_wrap<8>(dxyz, dq, B, N, M, sc, o_new, S, dbounds,
                                   nullptr);
      });
      std::printf(")%s\n", same ? "" : " FAIL: new != old");
      ok = ok && same;
      for (int v = 0; v < 2; ++v) {
        CHECK(cudaFree(di[v]));
        CHECK(cudaFree(dc[v]));
      }
      for (void* p : {(void*)dxyz, (void*)dq, (void*)dbounds})
        CHECK(cudaFree(p));
    }
  }
  {  // kernels 5 and 10 at the inference launch: 16 scenes
    CropArgs a{};
    a.B = 16;
    a.N = 16384;
    a.C = 5;
    a.M = 64;
    a.k = 512;
    const float radius = 4.f;
    a.r2 = (float)((double)radius * radius);
    std::vector<float> xyz = cloud(gen, a.B, a.N, false);
    // centres: (x, z) of 64 points of each scene in a random order (the
    // proposals' score order); the first far off (an empty crop)
    std::vector<float> cen((size_t)a.B * a.M * 2);
    std::uniform_int_distribution<int> pick(0, a.N - 1);
    std::uniform_real_distribution<float> u(0.f, 1.f);
    for (int b = 0; b < a.B; ++b)
      for (int m = 0; m < a.M; ++m) {
        const size_t j = (size_t)b * a.N + pick(gen);
        cen[((size_t)b * a.M + m) * 2] = m == 0 ? 500.f : xyz[3 * j];
        cen[((size_t)b * a.M + m) * 2 + 1] = m == 0 ? 500.f : xyz[3 * j + 2];
      }
    const size_t n_out = (size_t)a.C * a.B * a.M * a.k, n_cnt = a.B * a.M;
    for (int order = 0; order < 2; ++order) {
      if (order == 1) shuffle_rows(gen, xyz, a.B, a.N, 3);
      // channels x, y, z and two random ones
      std::vector<float> ch((size_t)a.B * a.C * a.N);
      for (int b = 0; b < a.B; ++b)
        for (int c = 0; c < a.C; ++c)
          for (int j = 0; j < a.N; ++j)
            ch[((size_t)b * a.C + c) * a.N + j] =
                c < 3 ? xyz[((size_t)b * a.N + j) * 3 + c] : u(gen);
      float* dxyz = to_device(xyz);
      float* dch = to_device(ch);
      float* dcen = to_device(cen);
      float *dv[2];
      int *dc[2];
      for (int v = 0; v < 2; ++v) {
        CHECK(cudaMalloc(&dv[v], n_out * 4));
        CHECK(cudaMalloc(&dc[v], n_cnt * 4));
      }
      CHECK(cudaMalloc(&a.bounds, (size_t)a.B * n_chunks(a.N) * 8));
      a.xyz = dxyz;
      a.ch = dch;
      a.centers = dcen;
      long long slab = 0, members = 0;
      int over = 0;
      for (int b = 0; b < a.B; ++b)
        for (int m = 0; m < a.M; ++m) {
          const float cx = cen[((size_t)b * a.M + m) * 2];
          const float cz = cen[((size_t)b * a.M + m) * 2 + 1];
          int cnt = 0;
          for (int j = 0; j < a.N; ++j) {
            const float* p = &xyz[((size_t)b * a.N + j) * 3];
            const float dz = cz - p[2], dx = cx - p[0];
            slab += dz * dz < a.r2;
            cnt += dx * dx + dz * dz < a.r2;
          }
          members += cnt;
          over += cnt > a.k;
        }
      // kernel 5 (z_window 0), then kernel 10 at the JAX default, 32 tiles
      for (int W : {0, 32}) {
        const float t_old = time_ms([&] {
          old_crop_gather_kernel<<<a.B * a.M, 256, a.k * 4>>>(
              dxyz, dch, dcen, a.B, a.N, a.C, a.M, a.k, a.r2, 1, W, dv[0],
              dc[0]);
          return (int)cudaGetLastError();
        }, e0, e1);
        const float t_new = time_ms([&] {
          return ws3d_crop_gather(dxyz, dch, dcen, a.B, a.N, a.C, a.M, a.k,
                                  a.r2, 1, W, dv[1], dc[1], a.bounds,
                                  nullptr);
        }, e0, e1);
        std::vector<float> av(n_out), bv(n_out);
        std::vector<int> ac(n_cnt), bc(n_cnt);
        CHECK(cudaMemcpy(av.data(), dv[0], n_out * 4,
                         cudaMemcpyDeviceToHost));
        CHECK(cudaMemcpy(ac.data(), dc[0], n_cnt * 4,
                         cudaMemcpyDeviceToHost));
        auto same_as_old = [&] {
          CHECK(cudaMemcpy(bv.data(), dv[1], n_out * 4,
                           cudaMemcpyDeviceToHost));
          CHECK(cudaMemcpy(bc.data(), dc[1], n_cnt * 4,
                           cudaMemcpyDeviceToHost));
          return std::memcmp(av.data(), bv.data(), n_out * 4) == 0 && ac == bc;
        };
        bool same = same_as_old();
        // kernel 5's counts of row 0 against the host's
        for (int m = 0; W == 0 && m < a.M && same; ++m) {
          int cnt = 0;
          for (int j = 0; j < a.N; ++j) {
            const float dx = cen[2 * m] - xyz[3 * j];
            const float dz = cen[2 * m + 1] - xyz[3 * j + 2];
            cnt += dx * dx + dz * dz < a.r2;
          }
          same = bc[m] == cnt;
        }
        std::printf("kernel %d inference B%d N%d M%d r%.0f k%d C%d W%d %s "
                    "(%.1f slab points and %.1f members a centre, %d "
                    "centres over k): old %.4f ms, new %.4f ms (%.2fx",
                    W ? 10 : 5, a.B, a.N, a.M, radius, a.k, a.C, W,
                    order ? "shuffled" : "sorted",
                    (double)slab / (a.B * a.M),
                    (double)members / (a.B * a.M), over, t_old, t_new,
                    t_old / t_new);
        for (const auto& z : kCropSizings) {
          CHECK(cudaMemset(dv[1], 0xff, n_out * 4));
          CHECK(cudaMemset(dc[1], 0xff, n_cnt * 4));
          const float tv =
              time_ms([&] { return z.launch(a, W, dv[1], dc[1]); }, e0, e1);
          const bool sv = same_as_old();
          same = same && sv;
          std::printf("; %s %.4f ms%s", z.name, tv, sv ? "" : " FAIL");
        }
        std::printf(")%s\n", same ? "" : " FAIL: new != old or host");
        ok = ok && same;
      }
      for (int v = 0; v < 2; ++v) {
        CHECK(cudaFree(dv[v]));
        CHECK(cudaFree(dc[v]));
      }
      for (void* p : {(void*)dxyz, (void*)dch, (void*)dcen, (void*)a.bounds})
        CHECK(cudaFree(p));
    }
  }
  std::printf("%s\n", ok ? "ok" : "FAIL");
  return ok ? 0 : 1;
}
