// Fused cylinder crop: BEV rank search + channel gather.
//
// Replaces the TPU kernel ws3d_tpu/ops/ball_query_pallas.py:
// _crop_gather_kernel in full mode (W = None; wrapper crop_gather_pallas).
// Semantics: points with (x-cx)^2 + (z-cz)^2 < r2 are the crop's members in
// ascending index order; cnt is their number over all N. Slot s takes member
// j(s): grouped mode repeats members 0..R-1 Q+1 times and the rest Q times
// (Q = k / cnt, R = k % cnt), wrap mode takes s % cnt; with cnt >= k both are
// the first k members. The C channels are gathered exactly; an empty crop
// returns zeros.
//
// What bounds it on the H100: the B*M*N BEV distance scan (the count needs
// every point) and the N*C channel reads per scene, both small; the output is
// C*B*M*k floats. A few microseconds of bytes at the main-path shapes.
//
// Design: one block per (scene, centre). The block scans the points in
// chunks of its size; a warp ballot plus per-warp counts in shared memory
// give each member its rank, and the first min(cnt, k) member indices land
// in shared memory. Then every slot maps to its member with integer
// arithmetic and the block writes the gathered channels, coalesced on k.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
crop_gather_kernel(const float* __restrict__ xyz, const float* __restrict__ ch,
                   const float* __restrict__ centers, int B, int N, int Cc,
                   int M, int k, float r2, int grouped,
                   float* __restrict__ out, int* __restrict__ cnt_out) {
  extern __shared__ int members[];  // k ints
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ int s_total;
  const int b = blockIdx.x / M, c = blockIdx.x % M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pb = xyz + (size_t)b * N * 3;
  const float cx = centers[((size_t)b * M + c) * 2];
  const float cz = centers[((size_t)b * M + c) * 2 + 1];

  int running = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int i = base + tid;
    bool in = false;
    if (i < N) in = sqdist2(cx - pb[3 * i], cz - pb[3 * i + 2]) < r2;
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
  if (tid == 0) {
    s_total = running;
    cnt_out[(size_t)b * M + c] = running;
  }
  __syncthreads();
  const int cnt = s_total;
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
// out (Cc, B, M, k) f32, cnt (B, M) i32.
WS3D_EXPORT int ws3d_crop_gather(const float* xyz, const float* channels,
                                 const float* centers, int B, int N, int Cc,
                                 int M, int k, float r2, int grouped,
                                 float* out, int* cnt, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || Cc <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)k;
  int err = ws3d_set_smem((const void*)crop_gather_kernel, smem);
  if (err) return err;
  crop_gather_kernel<<<B * M, kThreads, smem, (cudaStream_t)stream>>>(
      xyz, channels, centers, B, N, Cc, M, k, r2, grouped, out, cnt);
  return (int)cudaGetLastError();
}
