// Iterative furthest point sampling.
//
// Replaces the TPU kernel ws3d_tpu/ops/sampling.py:_fps_pallas_kernel
// (wrapper _fps_pallas). Semantics: seed index 0, the min-d2 cache starts at
// 1e10, each step picks argmax of the cache with the lowest index winning
// ties, and the picked coordinates are emitted beside the indices.
//
// What bounds it on the H100: latency, not bytes or FLOPs. The npoint steps
// are sequential and each ends in a block-wide argmax, so one row is one
// block and the step count times the reduction latency is the floor. The
// backbone has only B rows of 16384 points; stage 2 has many rows of <= 512.
//
// Design: one block per row. The row's coordinates sit in shared memory
// (structure of arrays, 12 bytes a point: 196 KB at N = 16384) and each
// thread keeps the min-d2 cache of its PPT points in registers for the whole
// sweep, so a step reads nothing from device memory. The block size follows
// N, so the many small stage-2 rows use small blocks and share an SM.
#include "common.cuh"

namespace {

__device__ __forceinline__ void argmax_merge(float& best, int& bi, float ov,
                                             int oi) {
  if (ov > best || (ov == best && oi < bi)) {
    best = ov;
    bi = oi;
  }
}

template <int PPT>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, int N, int npoint,
           int* __restrict__ idx_out, float* __restrict__ xyz_out) {
  extern __shared__ float spts[];
  float* sx = spts;
  float* sy = spts + N;
  float* sz = spts + 2 * N;
  const int row = blockIdx.x;
  const float* p = xyz + (size_t)row * N * 3;
  int* oi = idx_out + (size_t)row * npoint;
  float* oc = xyz_out + (size_t)row * npoint * 3;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  for (int i = tid; i < N; i += nt) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  float md[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) md[j] = j * nt + tid < N ? 1e10f : -1.f;
  __syncthreads();

  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_pick;
  if (tid == 0) {
    oi[0] = 0;
    oc[0] = p[0];
    oc[1] = p[1];
    oc[2] = p[2];
  }
  int last = 0;
  for (int it = 1; it < npoint; ++it) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float best = -2.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * nt + tid;
      if (i < N) {
        const float d = sqdist3(sx[i] - lx, sy[i] - ly, sz[i] - lz);
        md[j] = fminf(md[j], d);
        // ascending i within a thread: strict > keeps the lowest index
        if (md[j] > best) {
          best = md[j];
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(best, bi, __shfl_down_sync(0xffffffffu, best, off),
                   __shfl_down_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? s_val[lane] : -2.f;
      bi = lane < nwarps ? s_idx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        argmax_merge(best, bi, __shfl_down_sync(0xffffffffu, best, off),
                     __shfl_down_sync(0xffffffffu, bi, off));
      if (lane == 0) {
        s_pick = bi;
        oi[it] = bi;
        oc[3 * it] = sx[bi];
        oc[3 * it + 1] = sy[bi];
        oc[3 * it + 2] = sz[bi];
      }
    }
    __syncthreads();
    last = s_pick;
  }
}

}  // namespace

// xyz (R, N, 3) f32 -> idx (R, npoint) i32, picked coords (R, npoint, 3) f32.
WS3D_EXPORT int ws3d_fps(const float* xyz, int R, int N, int npoint, int* idx,
                         float* out_xyz, void* stream) {
  if (R <= 0 || N <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  int ppt = 4;
  while (ppt < 16 && (N + ppt - 1) / ppt > 1024) ppt *= 2;
  const int per = (N + ppt - 1) / ppt;
  if (per > 1024) return (int)cudaErrorInvalidValue;
  const int threads = (per + 31) / 32 * 32;
  const size_t smem = sizeof(float) * 3 * (size_t)N;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (ppt) {
    case 4:
      if ((err = ws3d_set_smem((const void*)fps_kernel<4>, smem))) return err;
      fps_kernel<4><<<R, threads, smem, s>>>(xyz, N, npoint, idx, out_xyz);
      break;
    case 8:
      if ((err = ws3d_set_smem((const void*)fps_kernel<8>, smem))) return err;
      fps_kernel<8><<<R, threads, smem, s>>>(xyz, N, npoint, idx, out_xyz);
      break;
    default:
      if ((err = ws3d_set_smem((const void*)fps_kernel<16>, smem))) return err;
      fps_kernel<16><<<R, threads, smem, s>>>(xyz, N, npoint, idx, out_xyz);
      break;
  }
  return (int)cudaGetLastError();
}

WS3D_EXPORT const char* ws3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
