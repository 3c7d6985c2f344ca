// The greedy NMS sweep: keep masks over rows already sorted by score.
//
// Replaces no TPU kernel: the JAX package runs the sweep inside jit as a
// lax.fori_loop (ws3d_tpu/ops/nms.py:_greedy_suppress), which never leaves
// the device. The port's plain version (ops/nms.greedy_suppress_plain) is a
// K-step Python loop of five or six launches a step: 576 steps a scene on
// the serving path (rpn_propose's radius NMS at K 512, finalize_detections'
// self-NMS at K 64), each issuing far less work than its host cost.
// Semantics, for every leading row: keep[i] is true iff valid[i] and no kept
// j < i has pair[j, i] > thresh, compared in f32 (NaN never suppresses).
// Only the strict upper triangle is read; the matrix need not be symmetric.
//
// What bounds it on the H100: the upper triangle is read once, 2 K (K - 1)
// bytes a row (33.5 MB at 64 x 512 x 512: 10 us at 3.35 TB/s), and the
// sweep is a chain of K dependent decisions that no amount of parallelism
// shortens.
//
// Design, one launch a call, one block a leading row:
// 1. The bitmask. Warp v of the block takes the suppressor rows j = v,
//    v + kSweepWarps, ... It reads pair[j, 32 w + lane] for the words w
//    from j / 32 on, coalesced, and a ballot packs `pair > thresh && i > j`
//    into word w of row j of the workspace (R, K, W) u32, W = ceil(K / 32).
//    Entries with i <= j are never loaded.
// 2. The sweep, after the block's barrier, by warp 0, 32 candidates a step:
//    word w of the "removed" bitmask, in shared memory, gives the candidates
//    suppressed by kept rows of earlier words; lane t holds the diagonal
//    word mask[32 w + t][w], and a 32-step chain of shuffles resolves the
//    suppressions inside the word, the same in every lane. Then each lane
//    ORs, for the words q > w it owns (q = w + 1 + lane + 32 k), the rows
//    kept in this word into removed[q].
// Every K takes the same path: the mask lives in the global workspace, and
// only the removed bitmask (4 W bytes) is in shared memory. Up to K 1,024
// each lane owns at most one later word; above it, several.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSweepWarps = 32;  // warps a block, one block a leading row
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kMaxRemovedBytes = 48 * 1024;  // default dynamic smem

__global__ void __launch_bounds__(kSweepWarps * 32)
greedy_sweep_kernel(const float* __restrict__ pair,
                    const uint8_t* __restrict__ valid, float thresh, int K,
                    unsigned* __restrict__ mask, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned removed[];
  const int W = (K + 31) >> 5;
  const int r = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned* M = mask + (size_t)r * K * W;

  // 1. word w of suppressor row j: the candidates i = 32 w + lane > j that
  // j suppresses
  for (int j = warp; j < K; j += kSweepWarps) {
    const float* row = pair + ((size_t)r * K + j) * K;
    unsigned* mrow = M + (size_t)j * W;
#pragma unroll 4
    for (int w = j >> 5; w < W; ++w) {
      const int i = (w << 5) + lane;
      const unsigned bits = __ballot_sync(kAll, i > j && i < K &&
                                                    row[i] > thresh);
      if (lane == 0) mrow[w] = bits;
    }
  }
  for (int q = threadIdx.x; q < W; q += blockDim.x) removed[q] = 0u;
  __syncthreads();  // the mask's words are visible to the whole block
  if (warp != 0) return;

  // 2. the sweep, 32 candidates a step
  const uint8_t* V = valid + (size_t)r * K;
  uint8_t* out = keep + (size_t)r * K;
  for (int w = 0; w < W; ++w) {
    const int i = (w << 5) + lane;
    const unsigned diag = i < K ? M[(size_t)i * W + w] : 0u;
    unsigned dropped = ~__ballot_sync(kAll, i < K && V[i] != 0) | removed[w];
    unsigned kept = 0u;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned d = __shfl_sync(kAll, diag, t);
      const unsigned take = ((dropped >> t) & 1u) - 1u;  // ~0u if kept
      kept |= take & (1u << t);
      dropped |= take & d;
    }
    if (i < K) out[i] = (uint8_t)((kept >> lane) & 1u);
    // a later word q exists only below the last word, so all 32 rows of
    // this one are < K
    const unsigned* rows = M + (size_t)(w << 5) * W;
    for (int q = w + 1 + lane; q < W; q += 32) {
      unsigned acc = removed[q];
      for (int t = 0; t < 32; ++t)
        if ((kept >> t) & 1u) acc |= rows[(size_t)t * W + q];
      removed[q] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// pair (R, K, K) f32, valid (R, K) bool (one byte each) -> keep (R, K)
// bool. mask is a workspace of R * K * ceil(K / 32) u32.
WS3D_EXPORT int ws3d_greedy_sweep(const float* pair, const void* valid,
                                  float thresh, int R, int K, void* mask,
                                  void* keep, void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const size_t removed_bytes = sizeof(unsigned) * (size_t)((K + 31) / 32);
  if (removed_bytes > kMaxRemovedBytes) return (int)cudaErrorInvalidValue;
  greedy_sweep_kernel<<<R, kSweepWarps * 32, removed_bytes,
                        (cudaStream_t)stream>>>(
      pair, (const uint8_t*)valid, thresh, K, (unsigned*)mask,
      (uint8_t*)keep);
  return (int)cudaGetLastError();
}
