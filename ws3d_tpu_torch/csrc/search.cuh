// Staged, pruned neighbour search: shared by ball_query.cu (kernels 6 and
// 6w), interpolate.cu (kernel 4), three_nn.cu (kernel 7), fused_sa.cu
// (kernels 2 and 3) and crop_gather.cu (kernels 5 and 10).
//
// A cloud is cut into chunks of kChunk consecutive points, and a pre-pass
// (launch_chunk_bounds) writes each chunk's z range. A block of queries
// stages the chunks it may need through shared memory, a ring of kStages
// tiles of kTileChunks chunks: warp 0 picks the chunks and starts their
// copies (cp.async) a tile ahead, and every warp searches the tile that has
// arrived. A chunk is left out when its z term bounds every d2 into it away
// from what the queries still need. The bound holds on any
// input: the term-rounded sqdist3 from a query to any point of a chunk is at
// least the z term fl(fl(qz - z_near)^2) of the chunk's nearer end (a
// rounded difference and a rounded square are monotone in |dz|, and
// rounding a sum of non-negative terms keeps it at least each term). On
// z-sorted clouds, the main path's, a chunk is a thin z slab and a query's
// ball or 3-NN sphere meets a few of them.
#pragma once

#include "common.cuh"

constexpr int kChunk = 32;       // points a chunk: one a lane
constexpr int kTileChunks = 16;  // chunks a staged tile
constexpr int kStages = 2;       // tiles of the ring: one in flight

__host__ __device__ __forceinline__ int n_chunks(int n) {
  return (n + kChunk - 1) / kChunk;
}

namespace {

// One warp a chunk: (min z, max z) of its points; NaN z are left out, and
// a chunk of NaN z only gets (+inf, -inf), whose z term from a finite query
// is +inf.
__global__ void __launch_bounds__(256)
chunk_bounds_kernel(const float* __restrict__ pts, int R, int n,
                    float2* __restrict__ bounds) {
  const int nch = n_chunks(n);
  const long long g = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (g >= (long long)R * nch) return;  // whole warp
  const int r = (int)(g / nch), c = (int)(g - (long long)r * nch);
  const int j = c * kChunk + (threadIdx.x & 31);
  const float inf = __int_as_float(0x7f800000);
  float lo = inf, hi = -inf;
  if (j < n) {
    const float z = pts[((size_t)r * n + j) * 3 + 2];
    if (z == z) lo = hi = z;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) bounds[g] = make_float2(lo, hi);
}

}  // namespace

// bounds[r * n_chunks(n) + c] = (min z, max z) of chunk c of each of R rows
// of n (x, y, z) points; returns a cudaError_t.
static inline int launch_chunk_bounds(const float* pts, int R, int n,
                                      float2* bounds, cudaStream_t stream) {
  const long long chunks = (long long)R * n_chunks(n);
  chunk_bounds_kernel<<<(unsigned)((chunks + 7) / 8), 256, 0, stream>>>(
      pts, R, n, bounds);
  return (int)cudaGetLastError();
}

// The z term from qz to the nearer end of the range b = (lo, hi), 0 inside.
__device__ __forceinline__ float zterm(float qz, float2 b) {
  const float dz = qz < b.x ? __fsub_rn(qz, b.x)
                 : qz > b.y ? __fsub_rn(qz, b.y) : 0.f;
  return __fmul_rn(dz, dz);
}

// The least z term from any z in [lo, hi] to the range b.
__device__ __forceinline__ float zterm_hull(float lo, float hi, float2 b) {
  const float dz = hi < b.x ? __fsub_rn(hi, b.x)
                 : lo > b.y ? __fsub_rn(lo, b.y) : 0.f;
  return __fmul_rn(dz, dz);
}

// The chunk bounds of a cloud sorted ascending by z, read in place: each
// chunk's first and last z, with no pre-pass and no workspace. On a cloud
// that is not sorted by z they are not the chunks' z ranges, and a search
// that prunes on them is no longer exact.
struct SortedChunkEnds {
  const float* pts;  // (n, 3)
  int n;
  __device__ __forceinline__ float2 operator[](int c) const {
    const int j = c * kChunk;
    return make_float2(pts[3 * j + 2], pts[3 * min(j + kChunk - 1, n - 1) + 2]);
  }
};

// The ring in shared memory (kRingFloats floats, a multiple of 4, at a
// 16-byte aligned address): each tile's points (3 * kChunk floats a chunk,
// as in global memory), each chunk's bounds and index, each tile's chunk
// count, and two floats a warp (one for each parity of the tile count)
// that warp 0 reads when it picks chunks: the warp's threshold.
struct TileRing {
  float* pts;
  float2* zb;
  int* cid;
  int* cnt;
  float* warp_v;  // [2][32]
};
constexpr int kRingSlots = kStages * kTileChunks;
constexpr int kRingFloats =
    (kRingSlots * (3 * kChunk + 3) + kStages + 64 + 3) & ~3;

__device__ __forceinline__ TileRing ring_at(float* base) {
  TileRing r;
  r.pts = base;
  r.zb = reinterpret_cast<float2*>(base + kRingSlots * 3 * kChunk);
  r.cid = reinterpret_cast<int*>(r.zb + kRingSlots);
  r.cnt = r.cid + kRingSlots;
  r.warp_v = reinterpret_cast<float*>(r.cnt + kStages);
  return r;
}

// The largest of the nw warps' values of parity `par`.
__device__ __forceinline__ float ring_max(const TileRing& ring, int par,
                                          int nw) {
  float t = -__int_as_float(0x7f800000);
  for (int w = 0; w < nw; ++w) t = fmaxf(t, ring.warp_v[32 * par + w]);
  return t;
}

// Warp 0: from position `pos` of a visit order of npos positions (order(p)
// is a chunk, or -1 for none) take the next chunks whose bounds pass
// need(bounds), at most kTileChunks, into ring slot `slot`; start the
// copies of their points from pb (n points; 16 bytes at a time when a16:
// pb 16-byte aligned and n % 4 == 0, else 4) and commit one cp.async group.
// `pos` moves past the last chunk taken. Four ballots of bounds are loaded
// at once, so the walk over skipped chunks waits on few round trips.
// bounds[c] is chunk c's (min z, max z): a pre-pass's workspace
// (launch_chunk_bounds) or SortedChunkEnds.
template <class Order, class Need, class Bounds>
__device__ __forceinline__ void ring_stage(const float* __restrict__ pb, int n,
                                           Bounds bounds,
                                           bool a16, int npos, Order order,
                                           Need need, int& pos,
                                           const TileRing& ring, int slot) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* cid = ring.cid + slot * kTileChunks;
  float2* zb = ring.zb + slot * kTileChunks;
  int got = 0;
  while (got < kTileChunks && pos < npos) {
    const int base = pos;
    int c[4];
    float2 b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = base + 32 * k + lane;
      c[k] = p < npos ? order(p) : -1;
      b[k] = c[k] >= 0 ? bounds[c[k]] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (got < kTileChunks) {  // warp-uniform
        const bool ok = c[k] >= 0 && need(b[k]);
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        const int nm = __popc(m), rank = __popc(m & below);
        const int take = min(nm, kTileChunks - got);
        if (ok && rank < take) {
          cid[got + rank] = c[k];
          zb[got + rank] = b[k];
        }
        pos = take < nm
                  ? base + 32 * k +
                        __ffs(__ballot_sync(0xffffffffu,
                                            ok && rank == take - 1))
                  : base + 32 * (k + 1);
        got += take;
      }
    }
  }
  __syncwarp();
  if (lane == 0) ring.cnt[slot] = got;
  float* dst = ring.pts + slot * kTileChunks * 3 * kChunk;
  const int nf = 3 * n;
  for (int k = 0; k < got; ++k) {  // a chunk is 3 * kChunk floats
    const int f0 = 3 * kChunk * cid[k];
    if (a16) {
      if (lane < 24 && f0 + 4 * lane < nf)
        cp_async16(dst + 3 * kChunk * k + 4 * lane, pb + f0 + 4 * lane);
    } else {
      for (int w = lane; w < 3 * kChunk; w += 32)
        if (f0 + w < nf) cp_async4(dst + 3 * kChunk * k + w, pb + f0 + w);
    }
  }
  cp_async_commit();
}

// The staged loop of a block, as both searches run it:
//   warp 0: kStages - 1 ring_stage calls (tiles 0 .. kStages - 2)
//   for t = 0, 1, ...:
//     warp 0: ring_wait(); then the block: __syncthreads()
//     tile t (slot t % kStages) empty: the order is exhausted, stop
//     warp 0: ring_stage into slot (t + kStages - 1) % kStages, reading the
//             warps' values of parity (t + 1) & 1
//     every warp: search tile t, then publish its value of parity t & 1
//   warp 0: ring_drain(); then the block: __syncthreads()
// Warp 0 stages a tile only after every warp is done with the tile that
// slot held (the barrier of iteration t follows the search of t - 1), and
// the values it reads were written before that barrier, while the warps
// write the other parity: its picks do not depend on timing. A value only
// falls as the search goes on, so a pick made with an older one is
// conservative.
__device__ __forceinline__ void ring_wait() { cp_async_wait<kStages - 2>(); }
__device__ __forceinline__ void ring_drain() { cp_async_wait<0>(); }

// The threads that run block_ball_query together: the whole block, or
// a group of whole warps with a barrier of its own (a warp-specialised
// block's producer warpgroup: fused_sa.cu); rank() counts from 0 in it.
struct BlockTeam {
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Where query qi's hits of scale s go: base + qi * stride + off[s].
struct BallRows {
  int* base;
  int stride;
  int off[kMaxScales];
};

// The multi-scale ball query of nq queries (qs: (x, y, z) rows in shared
// memory; ceil(nq / warps) <= kQW) over the n points of pb, exact on any
// input: for each query and scale the first S[s] indices with d2 < r2[s] in
// ascending index, padded with the first hit, all 0 for an empty ball.
// Chunks go in ascending index. Warp 0 stages a chunk unless its z term
// from the block's query z range is >= the largest r2 any query still
// needs; a warp skips a staged chunk for a query whose own z term is >= the
// largest r2 of that query's unfilled scales (a full scale needs no more
// hits), and a chunk in which no lane's d2 is below that r2. A hit needs
// d2 < r2, so no hit is skipped and the ranks stand. A warp takes
// consecutive queries (z neighbours on sorted clouds); a lane tests one
// point of a chunk against each of them (the point is read from shared
// memory once), ranks hits with ballot + popc, and a query stops once every
// scale is full. All threads of the team call it (it synchronises the
// team: by default the block); bounds are pb's chunk bounds
// (launch_chunk_bounds).
template <int kQW, class Team = BlockTeam>
__device__ __forceinline__ void block_ball_query(
    const float* __restrict__ pb, int n, const float2* __restrict__ bounds,
    bool a16, const float* qs, int nq, const BallScales& sc,
    const BallRows& rows, const TileRing& ring, Team team = Team()) {
  const int lane = threadIdx.x & 31, warp = team.rank() >> 5;
  const int nw = team.size() >> 5;
  const unsigned below = (1u << lane) - 1u;
  const float inf = __int_as_float(0x7f800000);
  const int per = (nq + nw - 1) / nw;
  const int q0 = warp * per, mine = max(0, min(per, nq - q0));
  float r2[kMaxScales];
  int S[kMaxScales], off[kMaxScales];
  float r2max = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    r2[s] = sc.r2[s];
    S[s] = sc.S[s];
    off[s] = rows.off[s];
    if (s < sc.n) r2max = fmaxf(r2max, r2[s]);
  }
  float qx[kQW], qy[kQW], qz[kQW], thr[kQW];
  int cnt[kQW][kMaxScales];
  int* row[kQW];
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int q = i < mine ? q0 + i : 0;
    qx[i] = qs[3 * q];
    qy[i] = qs[3 * q + 1];
    qz[i] = qs[3 * q + 2];
    thr[i] = i < mine ? r2max : -inf;  // -inf: nothing more to find
    row[i] = rows.base + (q0 + i) * rows.stride;
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) cnt[i][s] = 0;
  }
  float zlo = inf, zhi = -inf;  // the block's query z range
  for (int q = 0; q < nq; ++q) {
    zlo = fminf(zlo, qs[3 * q + 2]);
    zhi = fmaxf(zhi, qs[3 * q + 2]);
  }
  auto warp_thr = [&] {
    float t = -inf;
#pragma unroll
    for (int i = 0; i < kQW; ++i) t = fmaxf(t, thr[i]);
    return t;
  };
  if (lane == 0) ring.warp_v[warp] = ring.warp_v[32 + warp] = warp_thr();
  team.sync();

  const int nch = n_chunks(n);
  const auto order = [](int p) { return p; };
  int pos = 0;  // warp 0's cursor
  if (warp == 0) {
    const float t0 = ring_max(ring, 1, nw);
    for (int s = 0; s < kStages - 1; ++s)
      ring_stage(pb, n, bounds, a16, nch, order,
                 [=](float2 b) { return zterm_hull(zlo, zhi, b) < t0; }, pos,
                 ring, s);
  }
  for (int t = 0;; ++t) {
    if (warp == 0) ring_wait();
    team.sync();
    const int slot = t % kStages;
    const int nc = ring.cnt[slot];
    if (nc == 0) break;  // block-uniform
    if (warp == 0) {
      const float tb = ring_max(ring, (t + 1) & 1, nw);
      ring_stage(pb, n, bounds, a16, nch, order,
                 [=](float2 b) { return zterm_hull(zlo, zhi, b) < tb; }, pos,
                 ring, (t + kStages - 1) % kStages);
    }
    const float* tp = ring.pts + slot * kTileChunks * 3 * kChunk;
    for (int k = 0; k < nc; ++k) {
      const int c = ring.cid[slot * kTileChunks + k];
      const float2 b = ring.zb[slot * kTileChunks + k];
      const int j = c * kChunk + lane;
      const float* p = tp + 3 * kChunk * k + 3 * lane;
      const float px = p[0], py = p[1], pz = p[2];
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        if (!(zterm(qz[i], b) < thr[i])) continue;  // warp-uniform
        const float d = j < n ? sqdist3(qx[i] - px, qy[i] - py, qz[i] - pz)
                              : inf;
        if (!__any_sync(0xffffffffu, d < thr[i])) continue;
        float nt = -inf;
#pragma unroll
        for (int s = 0; s < kMaxScales; ++s) {
          if (s < sc.n) {
            const bool in = d < r2[s];
            const unsigned m = __ballot_sync(0xffffffffu, in);
            const int rank = cnt[i][s] + __popc(m & below);
            if (in && rank < S[s]) row[i][off[s] + rank] = j;
            cnt[i][s] += __popc(m);
            if (cnt[i][s] < S[s]) nt = fmaxf(nt, r2[s]);
          }
        }
        thr[i] = nt;
      }
    }
    if (lane == 0) ring.warp_v[32 * (t & 1) + warp] = warp_thr();
  }
  if (warp == 0) ring_drain();
  team.sync();
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    if (i < mine) {
#pragma unroll
      for (int s = 0; s < kMaxScales; ++s) {
        if (s < sc.n) {
          int* r = row[i] + off[s];
          const int nh = min(cnt[i][s], S[s]);
          const int first = nh > 0 ? r[0] : 0;
          for (int k = nh + lane; k < S[s]; k += 32) r[k] = first;
        }
      }
    }
  }
  __syncwarp();
}

// ---- the staged 3-NN search: kernels 4 (interpolate.cu) and 7 (three_nn.cu)

// Warp 0 stages the 3-NN search's next tile into `slot`: the next chunks of
// the visit order outward from the home chunk st[0] (positions 0, 1, 2, ...
// are home, home - 1, home + 1, home - 2, ...) whose z term from the
// block's query z range zr is not above tb; st[1] is the cursor.
template <class Bounds>
__device__ __forceinline__ void nn3_stage(const float* __restrict__ kb, int m,
                                          Bounds bb,
                                          bool a16, const TileRing& ring,
                                          int slot, float tb, const float* zr,
                                          int* st) {
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
__device__ __forceinline__ void nn3_point(const float* tp, int u, int j0,
                                          const float (&qx)[kQPT],
                                          const float (&qy)[kQPT],
                                          const float (&qz)[kQPT],
                                          float (&d)[kQPT][3],
                                          int (&nn)[kQPT][3]) {
  const float px = tp[3 * u], py = tp[3 * u + 1], pz = tp[3 * u + 2];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const float v = sqdist3(qx[i] - px, qy[i] - py, qz[i] - pz);
    if (v <= d[i][2]) top3_insert(v, j0 + u, d[i], nn[i]);
  }
}

// The 3-NN search of a block of kNNThreads threads: for the unknown points
// u0 + tid * kQPT + i (i < kQPT; past n, copies of the last) of ub (n
// (x, y, z) rows), the three known points of kb (m rows; bb their chunk
// bounds, launch_chunk_bounds' or SortedChunkEnds) with the smallest d2
// (sqdist3), the lowest index first on ties, the nearest repeated when
// m < 3: what a full search in ascending index with strict < gives, on any
// input with a pre-pass's bounds.
// Warp 0 stages the known chunks in a visit order that starts at the chunk
// nearest the block's query z range and steps outward, alternating sides;
// it stages a chunk unless its z term from the block's query z range is
// strictly greater than the largest third-best d2 of the block, and a warp
// skips a staged chunk whose z term from the warp's query z range is
// strictly greater than the warp's largest third-best d2 (strictly: an
// equal d2 can still win a tie towards a lower index). Every point of a
// skipped chunk has a larger d2 than the final third neighbour. Candidates
// come out of index order, so the running top-3 is ordered by (d2, index)
// (top3_insert). One staged known point (three broadcast shared loads)
// serves a thread's kQPT queries. All threads of the block call it (it
// synchronises the block).
template <int kQPT, class Bounds>
__device__ __forceinline__ void staged_three_nn(
    const float* __restrict__ ub, int n, int u0, const float* __restrict__ kb,
    int m, Bounds bb, bool a16, float (&d)[kQPT][3],
    int (&nn)[kQPT][3]) {
  constexpr int kW = kNNThreads / 32;  // warps
  __shared__ __align__(16) float sring[kRingFloats];
  __shared__ float s_zr[2][kW];
  __shared__ float s_blk[2];  // the block's query z range
  __shared__ unsigned s_tmin;
  __shared__ int s_home[2];
  __shared__ int s_st[2];     // warp 0's visit order: home, cursor
  const TileRing ring = ring_at(sring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const int nch = n_chunks(m);

  float qx[kQPT], qy[kQPT], qz[kQPT];
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
  for (int c = tid; c < nch; c += kNNThreads)
    atomicMin(&s_tmin,
              __float_as_uint(zterm_hull(s_blk[0], s_blk[1], bb[c])));
  __syncthreads();
  for (int c = tid; c < nch; c += kNNThreads) {
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

  // the staged loop; a warp's value is its largest third-best d2, and warp
  // 0 keeps its picking state in shared memory
  if (warp == 0)
    for (int s = 0; s < kStages - 1; ++s)
      nn3_stage(kb, m, bb, a16, ring, s, inf, s_blk, s_st);
  for (int t = 0;; ++t) {
    if (warp == 0) ring_wait();
    __syncthreads();
    const int slot = t % kStages;
    const int nc = ring.cnt[slot];
    if (nc == 0) break;  // block-uniform
    if (warp == 0)
      nn3_stage(kb, m, bb, a16, ring, (t + kStages - 1) % kStages,
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
          nn3_point<kQPT>(tp, u, j0, qx, qy, qz, d, nn);
      } else {
        for (int u = 0; u < m - j0; ++u)
          nn3_point<kQPT>(tp, u, j0, qx, qy, qz, d, nn);
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
  for (int i = 0; i < kQPT; ++i) top3_fill(d[i], nn[i]);
}

// ---- the listed rank search: kernels 6w (ball_query.cu), 5 and 10
// (crop_gather.cu)

// The shared scratch of listed_rank_search: a window's chunks to test and
// the warp counts (row 0 the list's, rows 1 and 2 the rounds' by parity).
// A kernel declares one `__shared__ ListedScratch<kWarps>`.
template <int kWarps>
struct ListedScratch {
  int list[kWarps * 32];
  int wc[3][kWarps];
};

// Before a launch of a listed-search kernel: the opt-in to `smem` bytes of
// dynamic shared memory where they and the kernel's `stat` static bytes
// pass 48 KB, then the chunk pre-pass into `bounds`; returns a cudaError_t.
static inline int prepare_listed_launch(const void* kernel, size_t smem,
                                        size_t stat, const float* pts, int R,
                                        int n, float2* bounds,
                                        cudaStream_t stream) {
  const int err = smem + stat > 48 * 1024 ? ws3d_set_smem(kernel, smem) : 0;
  return err ? err : launch_chunk_bounds(pts, R, n, bounds, stream);
}

// A block of kWarps warps ranks, in ascending index, the members among the
// points of the chunks in [c0, c1) that need(c) lists. For each window of
// kWarps * 32 chunks it lists those chunks in sc.list (ballot, warp counts
// in sc.wc[0], a prefix), then tests them in rounds, kU consecutive list
// entries a warp, member(j) for the 32 points j of each chunk (j may pass
// the cloud's end: member must be false there), the points read straight
// from global memory (L2). Each warp ballots its chunks' members and
// publishes its count in sc.wc[1 + round parity]; after a barrier it ranks
// each member by the running count, the counts of the round's earlier
// warps and its own earlier chunks: the ranks of an ascending scan over
// the listed chunks. The first `cap` members' indices land in
// members[0, cap). Returns, in every thread, the number of members:
// nothing stops early. Each window ends at a barrier, so `members` is
// complete on return.
template <int kWarps, int kU, class Need, class Member>
__device__ __forceinline__ int listed_rank_search(int c0, int c1, Need need,
                                                  Member member, int cap,
                                                  int* members,
                                                  ListedScratch<kWarps>& sc) {
  constexpr int kT = kWarps * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  // the counts of warps before this one, and of all, in row w of sc.wc
  const auto prefix = [&](int w, int& before, int& total) {
    before = total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int v = sc.wc[w][k];
      before += k < warp ? v : 0;
      total += v;
    }
  };
  int running = 0;  // members so far
  int round = 0;
  for (int w0 = c0; w0 < c1; w0 += kT) {
    const int c = w0 + threadIdx.x;
    const bool listed = c < c1 && need(c);
    const unsigned m = __ballot_sync(0xffffffffu, listed);
    if (lane == 0) sc.wc[0][warp] = __popc(m);
    __syncthreads();
    int before, L;
    prefix(0, before, L);
    if (listed) sc.list[before + __popc(m & below)] = c;
    __syncthreads();
    for (int e0 = 0; e0 < L; e0 += kWarps * kU, ++round) {
      unsigned hit[kU];
      int mine = 0;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + warp * kU + u;
        hit[u] = 0u;
        if (e < L) {  // warp-uniform
          hit[u] = __ballot_sync(0xffffffffu,
                                 member(sc.list[e] * kChunk + lane));
          mine += __popc(hit[u]);
        }
      }
      const int par = 1 + (round & 1);
      if (lane == 0) sc.wc[par][warp] = mine;
      __syncthreads();
      int rank, total;
      prefix(par, rank, total);
      rank += running;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = rank + __popc(hit[u] & below);
        if ((hit[u] >> lane & 1u) && r < cap)
          members[r] = sc.list[e0 + warp * kU + u] * kChunk + lane;
        rank += __popc(hit[u]);
      }
      running += total;
    }
    __syncthreads();  // the next window rewrites the list
  }
  return running;
}
