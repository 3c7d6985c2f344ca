// Fused set abstraction: ball query + gather + BN-folded ReLU MLP + max-pool.
//
// Replaces three TPU kernels:
//   ws3d_tpu/ops/fused_sa_bq_pallas.py:_kernel      (full: rank search over
//                                                     all P points)
//   ws3d_tpu/ops/fused_sa_window_pallas.py:_kernel  (windowed: z-sorted
//                                                     points, scan only the
//                                                     z-window of the query)
//   ws3d_tpu/ops/fused_sa_pallas.py:_kernel         (given: the indices come
//                                                     from the caller)
// Here they are one kernel template with three entry modes. Semantics: for
// each query the first S points with d2 < r2 in ascending index order, padded
// with the first hit, point 0 when the ball is empty (or, given, the S
// indices of its idx row); rows [xyz - q, feat] go through the MLP (ReLU
// after every layer) and are max-pooled over S. The TPU kernel of the given
// mode folds the centre into the first layer's bias; subtracting it from the
// row, as the other two modes do, is the same function.
//
// What bounds it on the H100: the MLP's f32 FLOPs (2 * B*M*S * sum ci*co; up
// to ~1.6 TFLOP per batch of stage-2 crops), far above the bytes it moves
// (the grouped tensor never reaches device memory). This first version runs
// them on the SIMT cores, 67 TFLOP/s at best; tensor cores are later work.
//
// Design: one block per (scene, Q queries). One warp per query scans points
// in ascending index with ballot + popc ranks and stops after S hits (the
// windowed entry binary-searches [lo, hi) in the sorted z first; the given
// mode copies the caller's indices instead). The Q*S gathered rows sit in
// shared memory (row widths padded to a multiple of 4);
// each layer is a product with 8x4 register tiles and float4 loads into the
// other ping-pong buffer, weights read through L1/L2; the last layer
// max-pools straight into a per-query row with shared atomics (ReLU outputs
// are >= 0, so the float bits order like ints). Q is sized so the buffers
// fit about half of the 227 KB a block may use.
#include "common.cuh"

namespace {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 256;

enum Mode { kFull = 0, kWindow = 1, kGiven = 2 };

struct MLPDesc {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = 3 + C, width[l + 1] = layer l out
};

// layer inputs are stored with their width padded to a multiple of 4
__host__ __device__ __forceinline__ int pad4(int c) { return (c + 3) & ~3; }

__device__ __forceinline__ int lower_bound_z(const float* pts, int P,
                                             double key) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((double)pts[3 * mid + 2] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound_z(const float* pts, int P,
                                             double key) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((double)pts[3 * mid + 2] <= key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
fused_sa_kernel(const float* __restrict__ xyz, const float* __restrict__ feat,
                const float* __restrict__ new_xyz,
                const int* __restrict__ given, int P, int C, int M,
                float r2, float win, int S, int Q, MLPDesc desc,
                const float* __restrict__ params, int bufA, int bufB,
                float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = desc.n_layers;
  const int cout = desc.width[L];
  const int groups = (M + Q - 1) / Q;
  const int b = blockIdx.x / groups;
  const int q0 = (blockIdx.x % groups) * Q;
  const int nq = min(Q, M - q0);
  const int R = Q * S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  float* bufs[2];
  bufs[0] = smem;
  bufs[1] = smem + (size_t)R * bufA;
  float* pooled = bufs[1] + (size_t)R * bufB;
  float* qs = pooled + (size_t)Q * cout;
  int* idx = reinterpret_cast<int*>(qs + Q * 3);

  const float* pb = xyz + (size_t)b * P * 3;
  const float* fb = feat + (size_t)b * P * C;
  for (int t = tid; t < nq * 3; t += nt)
    qs[t] = new_xyz[((size_t)b * M + q0) * 3 + t];
  for (int t = tid; t < Q * cout; t += nt) pooled[t] = 0.f;
  __syncthreads();

  if constexpr (MODE == kGiven) {
    // ---- the caller's indices, clamped into [0, P) (the wrapper's contract
    // is that they already are; the clamp only keeps a bad one in bounds)
    const int* gb = given + ((size_t)b * M + q0) * S;
    for (int t = tid; t < nq * S; t += nt) idx[t] = min(max(gb[t], 0), P - 1);
  } else {
    // ---- ball query: one warp per query, ascending index, stop after S hits
    BallScales sc;
    sc.n = 1;
    sc.r2[0] = r2;
    sc.S[0] = S;
    for (int qi = warp; qi < nq; qi += nwarps) {
      const float qx = qs[3 * qi], qy = qs[3 * qi + 1], qz = qs[3 * qi + 2];
      int lo = 0, hi = P;
      if (MODE == kWindow) {
        lo = lower_bound_z(pb, P, (double)qz - (double)win);
        hi = upper_bound_z(pb, P, (double)qz + (double)win);
      }
      int* rows[kMaxScales] = {idx + qi * S};
      warp_ball_query(pb, lo, hi, qx, qy, qz, sc, rows);
    }
  }
  __syncthreads();

  // ---- gather [xyz - q, feat] rows, zero-padded to a multiple of 4 columns
  const int cin = desc.width[0];
  const int kin = pad4(cin);
  const int Reff = nq * S;
  float* X = bufs[0];
  for (int t = tid; t < Reff * kin; t += nt) {
    const int r = t / kin, c = t - r * kin;
    const int j = idx[r];
    X[t] = c < 3     ? pb[3 * j + c] - qs[3 * (r / S) + c]
           : c < cin ? fb[(size_t)j * C + (c - 3)]
                     : 0.f;
  }
  __syncthreads();

  // ---- MLP, ping-pong through shared memory; last layer max-pools.
  // Each thread owns an 8-row x 4-column tile: per 4 k-steps it reads 8
  // float4 of X (shared) and 4 float4 of W (L1/L2) for 128 FMAs.
  const float* wp = params;
  for (int l = 0; l < L; ++l) {
    const int kp = pad4(desc.width[l]), co = desc.width[l + 1];
    const int CT = co >> 2;                     // co % 4 == 0 (host check)
    const float4* W4 = reinterpret_cast<const float4*>(wp);   // (kp, CT)
    const float4* bias4 = reinterpret_cast<const float4*>(wp + (size_t)kp * co);
    wp += (size_t)kp * co + co;
    const float* Xin = bufs[l & 1];
    float4* Y4 = reinterpret_cast<float4*>(bufs[(l + 1) & 1]);
    const bool last = (l == L - 1);
    const int RT = (Reff + 7) >> 3;
    for (int t = tid; t < RT * CT; t += nt) {
      const int ct = t % CT, r0 = (t / CT) * 8;
      // clamp the ragged edge to a valid row; its results are dropped
      const float4* xr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xr[i] = reinterpret_cast<const float4*>(
            Xin + (size_t)min(r0 + i, Reff - 1) * kp);
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k4 = 0; k4 < (kp >> 2); ++k4) {
        const float4* wk = W4 + (size_t)(4 * k4) * CT + ct;
        const float4 w0 = __ldg(wk), w1 = __ldg(wk + CT),
                     w2 = __ldg(wk + 2 * CT), w3 = __ldg(wk + 3 * CT);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = xr[i][k4];
          acc[i][0] = fmaf(a.w, w3.x, fmaf(a.z, w2.x, fmaf(a.y, w1.x,
                      fmaf(a.x, w0.x, acc[i][0]))));
          acc[i][1] = fmaf(a.w, w3.y, fmaf(a.z, w2.y, fmaf(a.y, w1.y,
                      fmaf(a.x, w0.y, acc[i][1]))));
          acc[i][2] = fmaf(a.w, w3.z, fmaf(a.z, w2.z, fmaf(a.y, w1.z,
                      fmaf(a.x, w0.z, acc[i][2]))));
          acc[i][3] = fmaf(a.w, w3.w, fmaf(a.z, w2.w, fmaf(a.y, w1.w,
                      fmaf(a.x, w0.w, acc[i][3]))));
        }
      }
      const float4 b4 = bias4[ct];
      const float bj[4] = {b4.x, b4.y, b4.z, b4.w};
      if (!last) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (r0 + i >= Reff) break;
          Y4[(size_t)(r0 + i) * CT + ct] = make_float4(
              fmaxf(acc[i][0] + bj[0], 0.f), fmaxf(acc[i][1] + bj[1], 0.f),
              fmaxf(acc[i][2] + bj[2], 0.f), fmaxf(acc[i][3] + bj[3], 0.f));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int qprev = -1;
          float mx = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (r0 + i >= Reff) break;
            const int q = (r0 + i) / S;
            const float v = fmaxf(acc[i][j] + bj[j], 0.f);
            if (q == qprev) {
              mx = fmaxf(mx, v);
            } else {
              if (qprev >= 0)
                atomicMax(reinterpret_cast<int*>(pooled + qprev * co + 4 * ct + j),
                          __float_as_int(mx));
              qprev = q;
              mx = v;
            }
          }
          if (qprev >= 0)
            atomicMax(reinterpret_cast<int*>(pooled + qprev * co + 4 * ct + j),
                      __float_as_int(mx));
        }
      }
    }
    __syncthreads();
  }

  for (int t = tid; t < nq * cout; t += nt)
    out[((size_t)b * M + q0) * cout + t] = pooled[t];
}

// Checks the widths, sizes the query block Q to the shared memory and
// launches mode MODE; returns a cudaError_t.
template <int MODE>
int launch_fused_sa(const float* xyz, const float* feat, const float* new_xyz,
                    const int* given, int B, int P, int C, int M, float r2,
                    float win, int S, int n_layers, const int* widths,
                    const float* params, float* out, void* stream) {
  if (B <= 0 || P <= 0 || M <= 0 || S <= 0 || n_layers < 1 ||
      n_layers > kMaxLayers || widths[0] != C + 3)
    return (int)cudaErrorInvalidValue;
  MLPDesc d;
  d.n_layers = n_layers;
  for (int l = 0; l <= kMaxLayers; ++l) d.width[l] = l <= n_layers ? widths[l] : 0;
  int bufA = 4, bufB = 4;  // layer l reads buffer l % 2
  for (int l = 0; l < n_layers; ++l) {
    if (widths[l + 1] <= 0 || widths[l + 1] % 4) return (int)cudaErrorInvalidValue;
    const int w = pad4(widths[l]);
    if (l & 1) bufB = w > bufB ? w : bufB;
    else bufA = w > bufA ? w : bufA;
  }
  const size_t per_q = sizeof(float) *
      ((size_t)S * (bufA + bufB) + widths[n_layers] + 3 + S);
  int Q = 64;
  while (Q > 1 && (Q * per_q > 110 * 1024 || Q / 2 >= M)) Q >>= 1;
  const size_t smem = Q * per_q;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = B * ((M + Q - 1) / Q);
  const int err = ws3d_set_smem((const void*)fused_sa_kernel<MODE>, smem);
  if (err) return err;
  fused_sa_kernel<MODE><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xyz, feat, new_xyz, given, P, C, M, r2, win, S, Q, d, params, bufA,
      bufB, out);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, P, 3), feat (B, P, C), new_xyz (B, M, 3) f32; params packs
// [W0 (pad4(ci), co) row-major with zero rows past ci, b0 (co), W1, b1, ...]
// (BN folded; every co a multiple of 4) -> out (B, M, width[n_layers]).
// windowed != 0 requires xyz and new_xyz sorted ascending by z.
WS3D_EXPORT int ws3d_fused_sa(const float* xyz, const float* feat,
                              const float* new_xyz, int B, int P, int C, int M,
                              float r2, float win, int S, int windowed,
                              int n_layers, const int* widths,
                              const float* params, float* out, void* stream) {
  if (windowed)
    return launch_fused_sa<kWindow>(xyz, feat, new_xyz, nullptr, B, P, C, M,
                                    r2, win, S, n_layers, widths, params, out,
                                    stream);
  return launch_fused_sa<kFull>(xyz, feat, new_xyz, nullptr, B, P, C, M, r2,
                                win, S, n_layers, widths, params, out, stream);
}

// The same with the indices given: idx (B, M, S) int32, each in [0, P).
WS3D_EXPORT int ws3d_fused_sa_idx(const float* xyz, const float* feat,
                                  const float* new_xyz, const int* idx, int B,
                                  int P, int C, int M, int S, int n_layers,
                                  const int* widths, const float* params,
                                  float* out, void* stream) {
  return launch_fused_sa<kGiven>(xyz, feat, new_xyz, idx, B, P, C, M, 0.f,
                                 0.f, S, n_layers, widths, params, out, stream);
}
