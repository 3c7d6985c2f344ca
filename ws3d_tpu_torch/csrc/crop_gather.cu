// Fused cylinder crop: BEV member search + channel gather, over all points
// (kernel 5) or over each centre's z-window (kernel 10).
//
// Replaces the TPU kernel ws3d_tpu/ops/ball_query_pallas.py:
// _crop_gather_kernel (wrapper crop_gather_pallas): full mode (W = None) and
// z-window mode (W < tiles, picked by lax.cond). Semantics: points with
// (x-cx)^2 + (z-cz)^2 < r2 (term-rounded, sqdist2) are the crop's members
// in ascending index order; cnt is their number over all N. Slot s takes
// member j(s): grouped mode repeats members 0..R-1 Q+1 times and the rest Q
// times (Q = k / cnt, R = k % cnt), wrap mode takes s % cnt; with cnt >= k
// both are the first k members. The C channels are gathered exactly; an
// empty crop returns zeros.
//
// What bounds it on the H100: bytes. The output is C*B*M*k floats (10.5 MB
// on the inference path: 16 scenes x 64 centres x 512 slots x 5 channels),
// beside 12 bytes a point in and 4C for each point some crop gathers (1,812
// of 16,384 a scene there); about 0.0042 ms at 3.35 TB/s. The count
// needs every member, so nothing stops early, but only the points of a
// centre's z slab can be members: on the main path's z-sorted scenes
// (16,384 points, r 4 m) a few thousand of the 16,384.
//
// Design (kernel 6w's, csrc/ball_query.cu): a pre-pass writes each 32-point
// chunk's z range into the workspace the wrapper allocates
// (launch_chunk_bounds, search.cuh). A block of kCropWarps warps takes one
// centre and runs listed_rank_search (search.cuh): it lists, in ascending
// index, the chunks whose z term from the centre is below r2 and tests
// them in rounds, kCropRound chunks a warp, with the points read straight
// from L2, a count a warp and a block prefix ranking the members. The
// listing is exact on any input: a member's rounded fl(dx^2) + fl(dz^2) is
// at least fl(dz^2), which is at least its chunk's z term. The first
// min(cnt, k) member indices stay in shared memory (k ints); then every
// slot maps to its member with integer arithmetic and the block writes the
// gathered channels, coalesced on k. On a shuffled cloud nearly every
// chunk spans the centre's z and nearly all are tested, as the dense scan
// tested every point.
//
// Window mode (z_window > 0): the candidate range [lo, hi) is that of the
// plain version's z_windows: home is the first point with pz >= cz in the
// binary search of torch.searchsorted, lo the first point of [0, home)
// whose own term fl((cz - pz)^2) is below r2 and hi the first of
// [home, N) whose term is not, each by that exact binary search (never on
// cz +- r computed in floats, which can drop a member at the boundary). On
// a z-sorted cloud the range holds every member; on any cloud the output
// is the plain version's. Warps 0 and 1 each run the home search, then
// the lower and the upper search, five levels of the binary search a round
// (warp_search): one load round trip for every five of the serial search's.
// A block whose range spans more than z_window 128-point tiles searches
// all N, as the TPU kernel's all-or-nothing fallback does per call; then
// the listed search runs over the chunks that meet the range, the points
// outside it masked.
//
// Both modes were measured (PERF.md §6) against the dense
// block scan they replaced (one block of 256 threads a centre ranking all
// N points, 64 barrier-separated steps), sorted and shuffled, at the
// inference launch, with 4, 8 and 16 warps a centre and 2, 4 and 8 chunks
// a warp a round. On an H100 SXM (700 W), with the pre-pass: kernel 5
// 0.061 -> 0.026 ms sorted (3,086 slab points and 1,435 members a centre),
// 0.062 -> 0.058 shuffled; kernel 10 0.054-0.059 -> 0.032 sorted, 0.062 ->
// 0.047 shuffled. 8 warps and 8 chunks, the fastest on kernel 5 sorted
// (the inference path's case), are kept: 4 warps come within 5 % (1-2 %
// faster on kernel 5 shuffled, 6 % on kernel 10 sorted), 16 warps lose
// 5-37 % (1,024 blocks of 512 threads need a second wave). The listed
// search leaves the bound about 4x away: each block still waits on a few
// dependent L2 round trips (the bounds, each round's points, the gather),
// and kernel 10 on its range search first.
#include "search.cuh"

namespace {

constexpr int kCropWarps = 8;  // warps a centre (a block)
constexpr int kCropRound = 8;  // chunks a warp tests a round
constexpr int kTile = 128;     // the TPU kernel's point tile, z_window's unit

// The whole warp: the serial binary search
//   while (a < e) { mid = (a + e) >> 1; left(mid) ? e = mid : a = mid + 1; }
// five levels a round. Lane l evaluates left() at the mid of node l + 1 of
// the next five levels' tree (heap order: node n's children are 2n, taken
// when left() holds, and 2n + 1), one load round trip for all 31; the warp
// then walks the levels on the ballot. It returns the serial search's `a`
// for any predicate, monotone or not.
template <class Left>
__device__ __forceinline__ int warp_search(int a, int e, Left left) {
  const int lane = threadIdx.x & 31;
  const int node = lane + 1;
  const int depth = 31 - __clz(node);
  while (a < e) {
    int na = a, ne = e;
    for (int t = depth - 1; t >= 0; --t) {
      const int mid = (na + ne) >> 1;
      if ((node >> t) & 1) na = mid + 1;
      else ne = mid;
    }
    const unsigned m = __ballot_sync(
        0xffffffffu, lane < 31 && na < ne && left((na + ne) >> 1));
    for (int n = 1, l = 0; l < 5 && a < e; ++l) {
      const int mid = (a + e) >> 1;
      if (m >> (n - 1) & 1u) {
        e = mid;
        n = 2 * n;
      } else {
        a = mid + 1;
        n = 2 * n + 1;
      }
    }
  }
  return a;
}

template <int kWarps, int kU>
__global__ void __launch_bounds__(kWarps * 32)
crop_gather_kernel(const float* __restrict__ xyz, const float* __restrict__ ch,
                   const float* __restrict__ centers,
                   const float2* __restrict__ bounds, int B, int N, int Cc,
                   int M, int k, float r2, int grouped, int z_window,
                   float* __restrict__ out, int* __restrict__ cnt_out) {
  constexpr int kT = kWarps * 32;
  extern __shared__ int members[];  // k ints
  __shared__ ListedScratch<kWarps> s_scratch;
  __shared__ int s_range[2];
  const int q = blockIdx.x;  // (b, m) flattened
  const int b = q / M;
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* pb = xyz + (size_t)b * N * 3;
  const float2* bb = bounds + (size_t)b * n_chunks(N);
  const float cx = centers[2 * (size_t)q], cz = centers[2 * (size_t)q + 1];

  int lo = 0, hi = N;
  if (z_window > 0) {
    if (warp < 2) {
      const int home =
          warp_search(0, N, [&](int j) { return pb[3 * j + 2] >= cz; });
      const auto near_z = [&](int j) {
        const float dz = cz - pb[3 * j + 2];
        return __fmul_rn(dz, dz) < r2;
      };
      const int end =
          warp == 0 ? warp_search(0, home, near_z)
                    : warp_search(home, N, [&](int j) { return !near_z(j); });
      if ((tid & 31) == 0) s_range[warp] = end;
    }
    __syncthreads();
    const int wlo = s_range[0], whi = s_range[1];
    const int tiles = whi > wlo ? (whi - 1) / kTile - wlo / kTile + 1 : 0;
    if (tiles <= z_window) {
      lo = wlo;
      hi = whi;
    }
  }

  const int cnt = listed_rank_search<kWarps, kU>(
      lo / kChunk, hi > lo ? n_chunks(hi) : lo / kChunk,
      [&](int c) { return zterm(cz, bb[c]) < r2; },
      [&](int j) {
        const float* p = pb + 3 * (size_t)j;
        return j >= lo && j < hi && sqdist2(cx - p[0], cz - p[2]) < r2;
      },
      k, members, s_scratch);
  if (tid == 0) cnt_out[q] = cnt;
  const int Q = cnt > 0 ? k / cnt : 0, R = cnt > 0 ? k % cnt : 0;
  const int thresh = R * (Q + 1);
  const size_t plane = (size_t)B * M * k;
  float* ob = out + (size_t)q * k;
  for (int s = tid; s < k; s += kT) {
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

// Launches kernel 5 or 10 with kWarps warps a centre and kU chunks a warp a
// round after the pre-pass; returns a cudaError_t.
template <int kWarps, int kU>
int launch_crop_gather(const float* xyz, const float* channels,
                       const float* centers, int B, int N, int Cc, int M,
                       int k, float r2, int grouped, int z_window, float* out,
                       int* cnt, float2* bounds, cudaStream_t st) {
  const size_t smem = sizeof(int) * (size_t)k;
  const int err = prepare_listed_launch(
      (const void*)crop_gather_kernel<kWarps, kU>, smem,
      sizeof(ListedScratch<kWarps>) + 2 * sizeof(int), xyz, B, N, bounds, st);
  if (err) return err;
  crop_gather_kernel<kWarps, kU>
      <<<(unsigned)((long long)B * M), kWarps * 32, smem, st>>>(
          xyz, channels, centers, bounds, B, N, Cc, M, k, r2, grouped,
          z_window, out, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3), channels (B, Cc, N), centers (B, M, 2) f32 ->
// out (Cc, B, M, k) f32, cnt (B, M) i32; bounds a workspace of
// B * n_chunks(N) float2 (the pre-pass writes it). z_window <= 0: kernel 5
// over all N; z_window > 0: the z-window mode of kernel 10.
WS3D_EXPORT int ws3d_crop_gather(const float* xyz, const float* channels,
                                 const float* centers, int B, int N, int Cc,
                                 int M, int k, float r2, int grouped,
                                 int z_window, float* out, int* cnt,
                                 void* bounds, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || Cc <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_crop_gather<kCropWarps, kCropRound>(
      xyz, channels, centers, B, N, Cc, M, k, r2, grouped, z_window, out, cnt,
      (float2*)bounds, (cudaStream_t)stream);
}
