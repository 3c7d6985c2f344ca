// Iterative furthest point sampling.
//
// Replaces the TPU kernel ws3d_tpu/ops/sampling.py:_fps_pallas_kernel
// (wrapper _fps_pallas). Semantics: seed index 0, the min-d2 cache starts at
// 1e10, each step picks argmax of the cache with the lowest index winning
// ties (d2 in the direct dx*dx + dy*dy + dz*dz form), and the picked
// coordinates are emitted beside the indices.
//
// What bounds it on the H100: latency, not bytes or FLOPs. The npoint - 1
// steps are sequential, and each ends in an argmax over the whole row, so
// the floor is the step count times the latency of that reduction.
//
// Two designs, by row size (cut-over kWarpMaxN points, measured on the
// card with both timed at every row class of the main path, PERF.md
// §6). In both, a thread keeps its points and their min-d2 cache
// in registers and takes its best (d2, index) by a tree; a warp reduces with
// two redux.sync (max of the d2 bits, then min of the index among equals);
// the pick's coordinates come from a copy of the points in shared memory.
//  - small rows (the stage-2 crops, hundreds of rows a call): one warp per
//    row. No barrier of any kind.
//  - large rows: a thread-block cluster of C CTAs per row, launched with
//    cudaLaunchKernelEx. Each CTA holds a contiguous slice of the row
//    (8 or 16 points a thread, 128 threads or fewer; at most 256). One
//    cluster barrier before the first step is required: a CTA may write
//    into another's shared memory only once every CTA of the cluster has
//    started, and the programming model does not promise that a cluster's
//    CTAs start together. A step is a block argmax (one __syncthreads), the
//    CTA's candidate (d2, index, x, y, z) written through distributed shared
//    memory into slot [step & 1][rank] of every CTA of the cluster, ONE
//    cluster barrier (arrive.release/wait.acquire), and a merge of the C
//    local slots in (d2 descending, index ascending) order, so all CTAs
//    agree on the pick without a second barrier. The double-buffered slots
//    are safe: slot parity p is rewritten two steps later, after a barrier
//    that every reader of p has passed. C is the largest of 16, 8, 4, 2, 1
//    with C * rows <= SMs and every row's cluster resident at once
//    (cudaOccupancyMaxActiveClusters): 8 at batch 16, 16 at batch 1. A
//    refused cluster launch returns its error; nothing falls back.
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpMaxN = 1024;    // rows up to this size: one warp a row
constexpr int kWarpRows = 4;       // rows (warps) a block of the warp kernel
constexpr int kClusterThreads = 128;   // threads a CTA aimed at (cluster)
constexpr int kClusterMaxThreads = 256;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSliceBytes = 200 * 1024;   // a CTA's coordinates

struct Cand {
  float d;
  int i;
  float x, y, z;
};

// The warp's best (d, i) in every lane: the largest d, the lowest i on
// ties. Two redux.sync: a cached d2 is >= 0, so its bits order as unsigned
// ints (an empty candidate, d < 0 with i = INT_MAX, counts as 0 and loses to
// every point).
__device__ __forceinline__ void warp_best(float& d, int& i) {
  const unsigned key = d >= 0.f ? __float_as_uint(d) : 0u;
  const unsigned best = __reduce_max_sync(0xffffffffu, key);
  i = (int)__reduce_min_sync(0xffffffffu,
                             key == best ? (unsigned)i : 0xffffffffu);
  d = __uint_as_float(best);
}

// One thread's points first + j*stride, j < PPT (those below `end`):
// update the min-d2 cache against (lx, ly, lz) and return the best (d, i)
// by a tree over j (indices ascend with j, so the left one wins ties).
template <int PPT>
__device__ __forceinline__ void scan_points(const float (&px)[PPT],
                                            const float (&py)[PPT],
                                            const float (&pz)[PPT],
                                            float (&md)[PPT], int first,
                                            int stride, int end, float lx,
                                            float ly, float lz, float& bd,
                                            int& bi) {
  float d[PPT];
  int ix[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = first + j * stride;
    if (i < end) {
      md[j] = fminf(md[j], sqdist3(px[j] - lx, py[j] - ly, pz[j] - lz));
      d[j] = md[j];
      ix[j] = i;
    } else {
      d[j] = -2.f;
      ix[j] = INT_MAX;
    }
  }
#pragma unroll
  for (int s = 1; s < PPT; s <<= 1)
#pragma unroll
    for (int j = 0; j + s < PPT; j += 2 * s)
      if (d[j + s] > d[j]) {
        d[j] = d[j + s];
        ix[j] = ix[j + s];
      }
  bd = d[0];
  bi = ix[0];
}

// The points first + j*stride below `end` into registers and their
// coordinates into the shared arrays s (x), s + n (y), s + 2n (z), at
// index i - first0.
template <int PPT>
__device__ __forceinline__ void load_points(const float* __restrict__ p,
                                            int first, int stride, int end,
                                            int first0, int n, float* s,
                                            float (&px)[PPT], float (&py)[PPT],
                                            float (&pz)[PPT],
                                            float (&md)[PPT]) {
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = first + j * stride;
    const bool in = i < end;
    px[j] = in ? p[3 * i] : 0.f;
    py[j] = in ? p[3 * i + 1] : 0.f;
    pz[j] = in ? p[3 * i + 2] : 0.f;
    md[j] = 1e10f;
    if (in) {
      s[i - first0] = px[j];
      s[n + i - first0] = py[j];
      s[2 * n + i - first0] = pz[j];
    }
  }
}

// ---- small rows: one warp a row, its coordinates also in shared memory
// (3 * 32 * PPT floats a warp) so the pick's are one broadcast load
template <int PPT>
__global__ void __launch_bounds__(32 * kWarpRows)
fps_warp_kernel(const float* __restrict__ xyz, int R, int N, int npoint,
                int* __restrict__ idx_out, float* __restrict__ xyz_out) {
  extern __shared__ float s_rows[];
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= R) return;            // a whole warp; no block barrier follows
  const int lane = threadIdx.x & 31;
  const int n = 32 * PPT;
  float* s = s_rows + (size_t)(threadIdx.x >> 5) * 3 * n;
  const float* p = xyz + (size_t)row * N * 3;
  int* oi = idx_out + (size_t)row * npoint;
  float* oc = xyz_out + (size_t)row * npoint * 3;
  float px[PPT], py[PPT], pz[PPT], md[PPT];
  load_points<PPT>(p, lane, 32, N, 0, n, s, px, py, pz, md);
  __syncwarp();
  float lx = s[0], ly = s[n], lz = s[2 * n];
  if (lane == 0) {
    oi[0] = 0;
    oc[0] = lx;
    oc[1] = ly;
    oc[2] = lz;
  }
  for (int it = 1; it < npoint; ++it) {
    float d;
    int i;
    scan_points<PPT>(px, py, pz, md, lane, 32, N, lx, ly, lz, d, i);
    warp_best(d, i);
    lx = s[i];
    ly = s[n + i];
    lz = s[2 * n + i];
    if (lane == 0) {
      oi[it] = i;
      oc[3 * it] = lx;
      oc[3 * it + 1] = ly;
      oc[3 * it + 2] = lz;
    }
  }
}

// ---- large rows: a cluster of C CTAs a row, `slice` points a CTA, their
// coordinates also in shared memory (3 * slice floats)
template <int PPT>
__global__ void __launch_bounds__(kClusterMaxThreads)
fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint,
                   int slice, int* __restrict__ idx_out,
                   float* __restrict__ xyz_out) {
  extern __shared__ float s_slice[];
  // every CTA's candidate of the step, by step parity: CTA r writes its own
  // into slot [parity][r] of every CTA before the barrier
  __shared__ Cand s_inbox[2][kMaxCluster];
  __shared__ float s_wd[32];
  __shared__ int s_wi[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  const float* p = xyz + (size_t)row * N * 3;
  int* oi = idx_out + (size_t)row * npoint;
  float* oc = xyz_out + (size_t)row * npoint * 3;
  const int lo = rank * slice;
  const int hi = min(N, lo + slice);
  float px[PPT], py[PPT], pz[PPT], md[PPT];
  load_points<PPT>(p, lo + tid, nt, hi, lo, slice, s_slice, px, py, pz, md);
  float lx = p[0], ly = p[1], lz = p[2];
  const bool writer = rank == 0 && tid == 0;
  if (writer) {
    oi[0] = 0;
    oc[0] = lx;
    oc[1] = ly;
    oc[2] = lz;
  }
  // every CTA of the cluster has started (and its slice is in shared
  // memory) before any CTA writes into another's s_inbox on step 1
  cluster.sync();
  for (int it = 1; it < npoint; ++it) {
    float d;
    int i;
    scan_points<PPT>(px, py, pz, md, lo + tid, nt, hi, lx, ly, lz, d, i);
    warp_best(d, i);
    if (lane == 0) {
      s_wd[warp] = d;
      s_wi[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      d = lane < nwarps ? s_wd[lane] : -2.f;
      i = lane < nwarps ? s_wi[lane] : INT_MAX;
      warp_best(d, i);
      if (lane < C) {
        Cand c;
        c.d = d;
        c.i = i;
        const bool mine = i < hi;  // false only for an empty slice
        c.x = mine ? s_slice[i - lo] : 0.f;
        c.y = mine ? s_slice[slice + i - lo] : 0.f;
        c.z = mine ? s_slice[2 * slice + i - lo] : 0.f;
        *cluster.map_shared_rank(&s_inbox[it & 1][rank], lane) = c;
      }
    }
    cluster.sync();                // barrier.cluster arrive.release + wait.acquire
    Cand c;
    if (lane < C) {
      c = s_inbox[it & 1][lane];
    } else {
      c.d = -2.f;
      c.i = INT_MAX;
    }
    d = c.d;
    i = c.i;
    warp_best(d, i);
    const int src = __ffs(__ballot_sync(0xffffffffu, c.i == i)) - 1;
    lx = __shfl_sync(0xffffffffu, c.x, src);
    ly = __shfl_sync(0xffffffffu, c.y, src);
    lz = __shfl_sync(0xffffffffu, c.z, src);
    if (writer) {
      oi[it] = i;
      oc[3 * it] = lx;
      oc[3 * it + 1] = ly;
      oc[3 * it + 2] = lz;
    }
  }
  cluster.sync();                  // no CTA leaves while others write to it
}

struct Plan {
  bool cluster;  // a cluster of C CTAs a row, else one warp a row
  int C;         // CTAs a cluster (1 on the warp route)
  int threads;   // threads a CTA (cluster route) or lanes a row (warp route)
  int ppt;       // points a thread
};

Plan warp_plan(int N) {
  int ppt = 1;
  while (32 * ppt < N) ppt *= 2;
  return {false, 1, 32, ppt};
}

// points a thread of the cluster kernel for a slice: 8 or 16, the fewer
// that keeps a CTA at kClusterThreads threads
int cluster_ppt(int slice) {
  return (slice + 7) / 8 > kClusterThreads ? 16 : 8;
}

using ClusterKernel = void (*)(const float*, int, int, int, int*, float*);

ClusterKernel cluster_kernel(int ppt) {
  return ppt == 8 ? fps_cluster_kernel<8> : fps_cluster_kernel<16>;
}

// Picks C for R rows of N points on the current device; returns a
// cudaError_t. Both kernels are opted in to the largest slice any plan
// uses. Every cluster launch plans anew: it costs about 1 us of host time
// (measured on an H100) against a launch of 1.3 ms or more.
int cluster_plan(int R, int N, Plan& plan) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  for (int ppt = 8; ppt <= 16 && !err; ppt *= 2) {
    err = (int)cudaFuncSetAttribute(
        (const void*)cluster_kernel(ppt),
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!err) err = ws3d_set_smem((const void*)cluster_kernel(ppt),
                                  kMaxSliceBytes);
  }
  if (err) return err;
  plan = {true, 0, 0, 0};
  // the largest C with one CTA an SM and every row resident at once; else
  // the smallest C whose slice fits a CTA
  for (int C = kMaxCluster; C >= 1; C >>= 1) {
    const int slice = (N + C - 1) / C;
    const int ppt = cluster_ppt(slice);
    const int threads = ((slice + ppt - 1) / ppt + 31) / 32 * 32;
    const size_t smem = 3 * sizeof(float) * (size_t)slice;
    // a smaller C only needs more threads and shared memory
    if (threads > kClusterMaxThreads || smem > kMaxSliceBytes) break;
    if (C > 1 && slice < 32) continue;
    int clusters = INT_MAX;
    if (C > 1) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = C;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(R * C);
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&clusters,
                                         (const void*)cluster_kernel(ppt),
                                         &cfg) != cudaSuccess) {
        cudaGetLastError();        // this C is not available: try a smaller
        continue;
      }
    }
    if (clusters < 1) continue;
    plan.C = C;
    plan.threads = threads;
    plan.ppt = ppt;
    if (C * R <= sms && clusters >= R) return 0;
  }
  return plan.C ? 0 : (int)cudaErrorInvalidValue;   // N too large a row
}

template <int PPT>
void launch_warp(const float* xyz, int R, int N, int npoint, int* idx,
                 float* out_xyz, cudaStream_t s) {
  // <= 48 KB (PPT <= 32): no opt-in needed
  const size_t smem = sizeof(float) * 3 * 32 * PPT * kWarpRows;
  fps_warp_kernel<PPT><<<(R + kWarpRows - 1) / kWarpRows, 32 * kWarpRows,
                         smem, s>>>(xyz, R, N, npoint, idx, out_xyz);
}

// Launches `plan` for R rows of N points; returns a cudaError_t.
int launch_plan(const Plan& plan, const float* xyz, int R, int N, int npoint,
                int* idx, float* out_xyz, cudaStream_t s) {
  if (!plan.cluster) {
    switch (plan.ppt) {
      case 1: launch_warp<1>(xyz, R, N, npoint, idx, out_xyz, s); break;
      case 2: launch_warp<2>(xyz, R, N, npoint, idx, out_xyz, s); break;
      case 4: launch_warp<4>(xyz, R, N, npoint, idx, out_xyz, s); break;
      case 8: launch_warp<8>(xyz, R, N, npoint, idx, out_xyz, s); break;
      case 16: launch_warp<16>(xyz, R, N, npoint, idx, out_xyz, s); break;
      default: launch_warp<32>(xyz, R, N, npoint, idx, out_xyz, s); break;
    }
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(R * plan.C);
  cfg.blockDim = dim3(plan.threads);
  const int slice = (N + plan.C - 1) / plan.C;
  cfg.dynamicSmemBytes = 3 * sizeof(float) * (size_t)slice;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, cluster_kernel(plan.ppt), xyz,
                                          N, npoint, slice, idx, out_xyz);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (R, N, 3) f32 -> idx (R, npoint) i32, picked coords (R, npoint, 3) f32.
// Rows of up to kWarpMaxN points run one warp a row, larger rows a cluster.
WS3D_EXPORT int ws3d_fps(const float* xyz, int R, int N, int npoint, int* idx,
                         float* out_xyz, void* stream) {
  if (R <= 0 || N <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  Plan plan = warp_plan(N);
  if (N > kWarpMaxN) {
    const int err = cluster_plan(R, N, plan);
    if (err) return err;
  }
  return launch_plan(plan, xyz, R, N, npoint, idx, out_xyz,
                     (cudaStream_t)stream);
}

WS3D_EXPORT const char* ws3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
