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
// What bounds it on the H100: the n*m distance scan (about 10 operations a
// pair; FP0 of one scene is 16384 x 4096) against the feature bytes (m*C in,
// n*C out). At FP0 the scan dominates, at FP2/FP3 the bytes.
//
// Design: a block of 128 threads owns 128 unknown points; known points are
// staged through shared memory in tiles and each thread keeps a running
// top-3 with strict < while scanning in ascending index (block_three_nn in
// common.cuh, which the 3-NN kernel of the backward shares, so both pick the
// same neighbours), which yields the (d2, index) order of the TPU's three
// masked-min passes. The block then writes the output rows with threads
// across channels (coalesced).
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
#include "common.cuh"

namespace {

constexpr int kQ = kNNThreads;  // unknown points per block

__global__ void __launch_bounds__(kQ)
three_interp_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known,
                    const float* __restrict__ feats, int n, int m, int C,
                    float* __restrict__ out) {
  __shared__ float tile[3 * kNNTile];
  __shared__ int s_idx[kQ][3];
  __shared__ float s_w[kQ][3];
  const int tiles = (n + kQ - 1) / kQ;
  const int b = blockIdx.x / tiles;
  const int u0 = (blockIdx.x % tiles) * kQ;
  const int tid = threadIdx.x;
  const int u = u0 + tid;
  const float* ub = unknown + (size_t)b * n * 3;
  const float* kb = known + (size_t)b * m * 3;
  const float* fb = feats + (size_t)b * m * C;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (u < n) {
    qx = ub[3 * u];
    qy = ub[3 * u + 1];
    qz = ub[3 * u + 2];
  }
  float d[3];
  int nn[3];
  block_three_nn(kb, m, qx, qy, qz, tile, d, nn);
  const float d0 = d[0], d1 = d[1], d2 = d[2];
  const int i0 = nn[0], i1 = nn[1], i2 = nn[2];
  const float r0 = 1.0f / (d0 + 1e-8f), r1 = 1.0f / (d1 + 1e-8f),
              r2 = 1.0f / (d2 + 1e-8f);
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  s_idx[tid][0] = i0;
  s_idx[tid][1] = i1;
  s_idx[tid][2] = i2;
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

// unknown (B, n, 3), known (B, m, 3), feats (B, m, C) f32 -> out (B, n, C).
WS3D_EXPORT int ws3d_three_interpolate(const float* unknown, const float* known,
                                       const float* feats, int B, int n, int m,
                                       int C, float* out, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int grid = B * ((n + kQ - 1) / kQ);
  three_interp_kernel<<<grid, kQ, 0, (cudaStream_t)stream>>>(unknown, known,
                                                             feats, n, m, C, out);
  return (int)cudaGetLastError();
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
