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
// Design: staged_three_nn (search.cuh), the staged search that kernel 7
// (three_nn.cu) runs too, so the backward weights the very neighbours the
// forward used: over the known cloud's 32-point chunks, whose z ranges a
// pre-pass writes into the workspace the wrapper allocates, a block of 128
// threads takes 128 * kQPT consecutive queries, kQPT a thread in
// registers; the visit order starts at the chunk nearest the block's query
// z range and steps outward, and a chunk is skipped where its z term is
// strictly greater than the third-best d2 of every query it could serve, so
// the result is the full search's on any input, with the top-3 in (d2,
// index) order, the order of the TPU's three masked-min passes. The
// weights and the three-row sum are the arithmetic they were, so kernel 8
// stays bit-equal.
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
  __shared__ int s_idx[kBQ][3];
  __shared__ float s_w[kBQ][3];
  const int tiles = (n + kBQ - 1) / kBQ;
  const int split = blockIdx.x % csplit;
  const int b = blockIdx.x / csplit / tiles;
  const int u0 = (blockIdx.x / csplit % tiles) * kBQ;
  const int tid = threadIdx.x;
  const float* fb = feats + (size_t)b * m * C;
  float d[kQPT][3];
  int nn[kQPT][3];
  staged_three_nn<kQPT>(unknown + (size_t)b * n * 3, n, u0,
                        known + (size_t)b * m * 3, m,
                        bounds + (size_t)b * n_chunks(m), a16 != 0, d, nn);

#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
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
