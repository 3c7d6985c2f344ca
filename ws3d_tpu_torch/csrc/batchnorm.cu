// Train-mode BatchNorm followed by ReLU over the trailing channel axis:
// one forward kernel and a backward of two kernels, the per-channel sums
// and then dx (ops/batchnorm.py).
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's
// nn.BatchNorm, which XLA fuses inside the jitted step. The port's eager
// composition (models/layers.py: mean, var, x - mean, * inv, * scale,
// + bias, relu) launches 7 full-size kernels forward and about 20 backward
// a layer, each reading or writing the whole (rows, C) tensor.
//
// The batch statistics stay torch.mean / torch.var (the caller computes
// them, and inv = 1 / sqrt(var + eps), outside these kernels), so that the
// forward is bit for bit the composition's:
//   y = max(((x - mean) * inv) * scale + bias, 0)
// with each operation rounded on its own (no FMA contraction). The
// backward, with m = [y > 0] recomputed from x by the same arithmetic,
// gm = g m and xhat = (x - mean) inv over N rows:
//   dbias  = sum gm,  dscale = sum gm xhat,
//   dx     = scale inv (gm - dbias / N - xhat dscale / N),
// which also carries the gradient through the mean and the variance. The
// two are separate entry points so that a global batch of several ranks
// can all-reduce the sums between them; dx then takes the global sums and
// the global N.
//
// What bounds it on the H100: bytes. The forward reads x and writes y; the
// sums read x and g; dx reads x and g and writes dx: 7 passes over the
// tensor at 3.35 TB/s, every operation far under the f32 SIMT rate.
//
// Design: channel-last rows of C floats, C a multiple of 4 (every stage-1
// width is), read and written as 16-byte float4s. A block of kThreads
// threads takes rows_per_pass = kThreads / (C / 4) rows at a time, thread
// t the 4 channels 4 (t % (C / 4)) .. of row t / (C / 4). A thread's
// channels never change, so its per-channel constants live in registers,
// and it walks its rows with a grid stride, kUnroll rows' loads in flight
// at a time. The sums are deterministic, with no float atomics: each
// thread sums its rows in order, the block adds its rows_per_pass partial
// rows in order into one partial row of the workspace, and the last block
// to finish (an atomic ticket on an integer) adds the blocks' partial rows
// in block order.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kUnroll = 4;      // rows a thread has in flight
constexpr int kBlocksPerSM = 8; // forward and dx grids: at most this a SM

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int j, float f) {
  if (j == 0) v.x = f; else if (j == 1) v.y = f;
  else if (j == 2) v.z = f; else v.w = f;
}

// ((x - mean) * inv) * scale + bias, each operation rounded on its own as
// the composition's separate kernels round it
__device__ __forceinline__ float bn_pre(float x, float mean, float inv,
                                        float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), inv), scale),
                   bias);
}

// torch.relu: NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// A thread's place: its group q of 4 channels, its row within a pass and
// the rows a pass; false for the threads left over when C / 4 does not
// divide kThreads.
__device__ __forceinline__ bool place(int C, int& q, int& row, int& rpp) {
  const int groups = C / 4;
  rpp = kThreads / groups;
  q = threadIdx.x % groups;
  row = threadIdx.x / groups;
  return row < rpp;
}

// The per-channel constants of a thread's 4 channels.
struct Channels {
  float m[4], iv[4], s[4], b[4];
  __device__ __forceinline__ Channels(const float* mean, const float* inv,
                                      const float* scale, const float* bias,
                                      int q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = mean[4 * q + j];
      iv[j] = inv[4 * q + j];
      s[j] = scale[4 * q + j];
      b[j] = bias[4 * q + j];
    }
  }
  __device__ __forceinline__ float pre(float x, int j) const {
    return bn_pre(x, m[j], iv[j], s[j], b[j]);
  }
  __device__ __forceinline__ float xhat(float x, int j) const {
    return __fmul_rn(__fsub_rn(x, m[j]), iv[j]);
  }
};

__global__ void __launch_bounds__(kThreads)
bn_relu_forward_kernel(const float4* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, long long R, int C,
                       float4* __restrict__ y) {
  int q, row, rpp;
  if (!place(C, q, row, rpp)) return;
  const Channels ch(mean, inv, scale, bias, q);
  const long long step = (long long)gridDim.x * rpp;
  const int groups = C / 4;
  for (long long r0 = (long long)blockIdx.x * rpp + row; r0 < R;
       r0 += kUnroll * step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * step;
      if (r < R) v[u] = x[r * groups + q];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * step;
      if (r < R) {
        float4 o;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          set_lane(o, j, relu(ch.pre(lane(v[u], j), j)));
        y[r * groups + q] = o;
      }
    }
  }
}

// Kernel 1 of the backward: sums (2, C), dbias = sum gm then
// dscale = sum gm xhat, over the R rows. partial is (gridDim.x, 2, C);
// ticket an int the entry point zeroes.
__global__ void __launch_bounds__(kThreads)
bn_relu_sums_kernel(const float4* __restrict__ x,
                    const float4* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, long long R, int C,
                    float* __restrict__ partial, unsigned* __restrict__ ticket,
                    float* __restrict__ sums) {
  __shared__ float red[2][kThreads * 4];
  __shared__ bool last;
  int q, row, rpp;
  if (place(C, q, row, rpp)) {
    const Channels ch(mean, inv, scale, bias, q);
    float sb[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
    const long long step = (long long)gridDim.x * rpp;
    const int groups = C / 4;
    for (long long r0 = (long long)blockIdx.x * rpp + row; r0 < R;
         r0 += kUnroll * step) {
      float4 xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + u * step;
        if (r < R) {
          xv[u] = x[r * groups + q];
          gv[u] = g[r * groups + q];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * step < R) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xj = lane(xv[u], j);
            const float gm = ch.pre(xj, j) > 0.f ? lane(gv[u], j) : 0.f;
            sb[j] += gm;
            ss[j] += gm * ch.xhat(xj, j);
          }
        }
      }
    }
    // the block's partial rows: red[.][row * C + channel]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][row * C + 4 * q + j] = sb[j];
      red[1][row * C + 4 * q + j] = ss[j];
    }
  }
  __syncthreads();
  // thread c adds the block's rows in order into its partial row
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a0 = 0.f, a1 = 0.f;
    for (int k = 0; k < rpp; ++k) {
      a0 += red[0][k * C + c];
      a1 += red[1][k * C + c];
    }
    partial[((size_t)blockIdx.x * 2 + 0) * C + c] = a0;
    partial[((size_t)blockIdx.x * 2 + 1) * C + c] = a1;
  }
  __threadfence();  // the partial row is visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block adds the partial rows in block order: lane c of `lanes`
  // takes channels c, c + lanes, ...; its group k the blocks k, k + groups,
  // ...; then the groups are added in order. The same order whichever block
  // comes last.
  const int lanes = C < kThreads ? C : kThreads;
  const int ngroups = kThreads / lanes;
  const int ln = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int P = gridDim.x;
  for (int c0 = 0; c0 < C; c0 += lanes) {
    const int c = c0 + ln;
    float a0 = 0.f, a1 = 0.f;
    if (grp < ngroups && c < C) {
      for (int p = grp; p < P; p += ngroups) {
        a0 += __ldcg(partial + ((size_t)p * 2 + 0) * C + c);
        a1 += __ldcg(partial + ((size_t)p * 2 + 1) * C + c);
      }
    }
    __syncthreads();
    if (grp < ngroups) {
      red[0][grp * lanes + ln] = a0;
      red[1][grp * lanes + ln] = a1;
    }
    __syncthreads();
    if (grp == 0 && c < C) {
      float t0 = 0.f, t1 = 0.f;
      for (int k = 0; k < ngroups; ++k) {
        t0 += red[0][k * lanes + ln];
        t1 += red[1][k * lanes + ln];
      }
      sums[c] = t0;
      sums[C + c] = t1;
    }
  }
}

// Kernel 2 of the backward: dx of the R rows from x, g and the sums over
// N rows (N = R on one process, the global count in a global batch).
__global__ void __launch_bounds__(kThreads)
bn_relu_dx_kernel(const float4* __restrict__ x, const float4* __restrict__ g,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ sums, long long R, int C,
                  long long N, float4* __restrict__ dx) {
  int q, row, rpp;
  if (!place(C, q, row, rpp)) return;
  const Channels ch(mean, inv, scale, bias, q);
  float k1[4], mb[4], ms[4];
  const float rn = 1.f / (float)N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    k1[j] = ch.s[j] * ch.iv[j];
    mb[j] = sums[4 * q + j] * rn;
    ms[j] = sums[C + 4 * q + j] * rn;
  }
  const long long step = (long long)gridDim.x * rpp;
  const int groups = C / 4;
  for (long long r0 = (long long)blockIdx.x * rpp + row; r0 < R;
       r0 += kUnroll * step) {
    float4 xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * step;
      if (r < R) {
        xv[u] = x[r * groups + q];
        gv[u] = g[r * groups + q];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * step;
      if (r < R) {
        float4 o;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xj = lane(xv[u], j);
          const float gm = ch.pre(xj, j) > 0.f ? lane(gv[u], j) : 0.f;
          set_lane(o, j, k1[j] * (gm - mb[j] - ch.xhat(xj, j) * ms[j]));
        }
        dx[r * groups + q] = o;
      }
    }
  }
}

bool takes(int C, const void* a, const void* b, const void* c) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c;
  return C > 0 && C % 4 == 0 && C / 4 <= kThreads && (any & 15u) == 0;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// blocks for R rows at rows_per_pass rows a block, at most `cap`
int grid_for(long long R, int C, long long cap) {
  const long long rpp = kThreads / (C / 4);
  long long n = (R + rpp - 1) / rpp;
  if (n > cap) n = cap;
  return n < 1 ? 1 : (int)n;
}

}  // namespace

// x (R, C) f32, mean / inv / scale / bias (C) f32 -> y (R, C) f32. C a
// multiple of 4 up to 4 kThreads, x and y 16-byte aligned.
WS3D_EXPORT int ws3d_bn_relu_forward(const float* x, const float* mean,
                                     const float* inv, const float* scale,
                                     const float* bias, long long R, int C,
                                     float* y, void* stream) {
  const int sms = sm_count();
  if (R < 0 || !takes(C, x, y, y) || sms == 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  bn_relu_forward_kernel<<<grid_for(R, C, (long long)sms * kBlocksPerSM),
                           kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, mean, inv, scale, bias, R, C, (float4*)y);
  return (int)cudaGetLastError();
}

// Kernel 1 of the backward of ws3d_bn_relu_forward for the cotangent g
// (R, C) f32: sums (2, C), dbias then dscale. workspace holds
// max_blocks * 2 * C floats of partial sums, then one u32 ticket.
WS3D_EXPORT int ws3d_bn_relu_sums(const float* x, const float* g,
                                  const float* mean, const float* inv,
                                  const float* scale, const float* bias,
                                  long long R, int C, int max_blocks,
                                  float* workspace, float* sums,
                                  void* stream) {
  if (R < 0 || !takes(C, x, g, g) || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* ticket =
      reinterpret_cast<unsigned*>(workspace + (size_t)max_blocks * 2 * C);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  bn_relu_sums_kernel<<<grid_for(R, C, max_blocks), kThreads, 0, s>>>(
      (const float4*)x, (const float4*)g, mean, inv, scale, bias, R, C,
      workspace, ticket, sums);
  return (int)cudaGetLastError();
}

// Kernel 2: dx (R, C) from x, g and sums (2, C) over N >= R rows.
WS3D_EXPORT int ws3d_bn_relu_dx(const float* x, const float* g,
                                const float* mean, const float* inv,
                                const float* scale, const float* bias,
                                const float* sums, long long R, int C,
                                long long N, float* dx, void* stream) {
  const int sms = sm_count();
  if (R < 0 || N < R || !takes(C, x, g, dx) || sms == 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  bn_relu_dx_kernel<<<grid_for(R, C, (long long)sms * kBlocksPerSM),
                      kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)g, mean, inv, scale, bias, sums, R, C,
      N, (float4*)dx);
  return (int)cudaGetLastError();
}
