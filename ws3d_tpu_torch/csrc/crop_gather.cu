// Fused cylinder crop: BEV rank search + channel gather, over all points
// (kernel 5) or over each centre's z-window of a z-sorted cloud (kernel 10).
//
// Replaces the TPU kernel ws3d_tpu/ops/ball_query_pallas.py:
// _crop_gather_kernel (wrapper crop_gather_pallas): full mode (W = None) and
// z-window mode (W < tiles, picked by lax.cond). Semantics: points with
// (x-cx)^2 + (z-cz)^2 < r2 are the crop's members in ascending index order;
// cnt is their number over all N. Slot s takes member j(s): grouped mode
// repeats members 0..R-1 Q+1 times and the rest Q times (Q = k / cnt,
// R = k % cnt), wrap mode takes s % cnt; with cnt >= k both are the first k
// members. The C channels are gathered exactly; an empty crop returns zeros.
//
// What bounds it on the H100: the BEV distance scan (the count needs every
// candidate point) and the N*C channel reads per scene, both small; the
// output is C*B*M*k floats. A few microseconds of bytes at the main-path
// shapes.
//
// Design: one block per (scene, centre). The block scans its points in
// chunks of its size; a warp ballot plus per-warp counts give each member
// its rank (block_rank_scan in common.cuh, shared with kernel 6w), and the
// first min(cnt, k) member indices land in shared memory. Then every slot
// maps to its member with integer arithmetic and the block writes the
// gathered channels, coalesced on k.
//
// Window mode (z_window > 0, points sorted ascending by z): a member's own
// term fl((cz - pz)^2) is below r2, and that term falls monotonically
// towards the centre on each side of it along the sorted cloud, so the
// candidates are one contiguous range. Thread 0 finds it by binary search
// on that very predicate (never on cz +- r computed in floats, which can
// drop a member at the boundary). A block whose range spans more than
// z_window 128-point tiles scans all N, as the TPU kernel's all-or-nothing
// fallback does per call; the output is identical either way.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // the TPU kernel's point tile, z_window's unit

__global__ void __launch_bounds__(kThreads)
crop_gather_kernel(const float* __restrict__ xyz, const float* __restrict__ ch,
                   const float* __restrict__ centers, int B, int N, int Cc,
                   int M, int k, float r2, int grouped, int z_window,
                   float* __restrict__ out, int* __restrict__ cnt_out) {
  extern __shared__ int members[];  // k ints
  __shared__ int warp_cnt[kThreads / 32];
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
      int a = 0, e = N;  // home: the first point with pz >= cz
      while (a < e) {
        const int mid = (a + e) >> 1;
        if (pb[3 * mid + 2] < cz) a = mid + 1;
        else e = mid;
      }
      const int home = a;
      a = 0;  // below home near_z only rises with the index
      e = home;
      while (a < e) {
        const int mid = (a + e) >> 1;
        if (near_z(mid)) e = mid;
        else a = mid + 1;
      }
      const int wlo = a;
      a = home;  // from home on near_z only falls
      e = N;
      while (a < e) {
        const int mid = (a + e) >> 1;
        if (near_z(mid)) a = mid + 1;
        else e = mid;
      }
      const int whi = a;
      const int tiles = whi > wlo ? (whi - 1) / kTile - wlo / kTile + 1 : 0;
      s_range[0] = tiles <= z_window ? wlo : 0;
      s_range[1] = tiles <= z_window ? whi : N;
    }
    __syncthreads();
    lo = s_range[0];
    hi = s_range[1];
  }

  const int cnt = block_rank_scan<kThreads>(
      lo, hi,
      [&](int i) { return sqdist2(cx - pb[3 * i], cz - pb[3 * i + 2]) < r2; },
      k, members, warp_cnt);
  if (tid == 0) cnt_out[(size_t)b * M + c] = cnt;
  const int Q = cnt > 0 ? k / cnt : 0, R = cnt > 0 ? k % cnt : 0;
  const int thresh = R * (Q + 1);
  const size_t plane = (size_t)B * M * k;
  float* ob = out + ((size_t)b * M + c) * k;
  for (int s = tid; s < k; s += kThreads) {
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

}  // namespace

// xyz (B, N, 3), channels (B, Cc, N), centers (B, M, 2) f32 ->
// out (Cc, B, M, k) f32, cnt (B, M) i32. z_window <= 0: every block scans
// all N (kernel 5); z_window > 0: the z-window mode of kernel 10, which
// needs xyz sorted ascending by z.
WS3D_EXPORT int ws3d_crop_gather(const float* xyz, const float* channels,
                                 const float* centers, int B, int N, int Cc,
                                 int M, int k, float r2, int grouped,
                                 int z_window, float* out, int* cnt,
                                 void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || Cc <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)k;
  int err = ws3d_set_smem((const void*)crop_gather_kernel, smem);
  if (err) return err;
  crop_gather_kernel<<<B * M, kThreads, smem, (cudaStream_t)stream>>>(
      xyz, channels, centers, B, N, Cc, M, k, r2, grouped, z_window, out, cnt);
  return (int)cudaGetLastError();
}
