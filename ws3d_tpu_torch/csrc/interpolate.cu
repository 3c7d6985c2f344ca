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
// top-3 with strict < while scanning in ascending index, which yields the
// (d2, index) order of the TPU's three masked-min passes. The block then
// writes the output rows with threads across channels (coalesced).
#include "common.cuh"

namespace {

constexpr int kQ = 128;      // unknown points per block
constexpr int kTile = 1024;  // known points per shared-memory tile

__global__ void __launch_bounds__(kQ)
three_interp_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known,
                    const float* __restrict__ feats, int n, int m, int C,
                    float* __restrict__ out) {
  __shared__ float kx[kTile], ky[kTile], kz[kTile];
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
  const float inf = __int_as_float(0x7f800000);
  float d0 = inf, d1 = inf, d2 = inf;
  int i0 = -1, i1 = -1, i2 = -1;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int t = tid; t < cnt; t += kQ) {
      kx[t] = kb[3 * (t0 + t)];
      ky[t] = kb[3 * (t0 + t) + 1];
      kz[t] = kb[3 * (t0 + t) + 2];
    }
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      const float d = sqdist3(qx - kx[t], qy - ky[t], qz - kz[t]);
      const int j = t0 + t;
      if (d < d2) {
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = j;
          } else {
            d1 = d;
            i1 = j;
          }
        } else {
          d2 = d;
          i2 = j;
        }
      }
    }
  }
  if (i1 < 0) {  // m < 3: repeat the nearest
    d1 = d0;
    i1 = i0;
  }
  if (i2 < 0) {
    d2 = d0;
    i2 = i0;
  }
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
