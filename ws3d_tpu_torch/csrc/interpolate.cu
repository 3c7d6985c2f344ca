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
// points (the visits of the plain windowed search, ops/interpolate.py).
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
// index) order, the order of the TPU's three masked-min passes.
// The library launches kQPT 1: 2 and 4 were measured too (PERF.md §6),
// and more queries a thread lost at every main-path shape (the
// pruned search leaves few pairs to share a load, and the registers cut
// the warps that hide latency); the launch bounds ask for
// kInterpMinBlocks blocks an SM, 64 registers a thread (4 and 12 were
// measured too; at 12, 40 registers a thread, the kernel spills).
// Small launches (FP2, FP3: a few thousand queries, 512 channels) would
// leave most SMs idle, so below two blocks an SM, where the known cloud is
// small beside the channels, the host splits the channels over blocks,
// each block searching its queries again. The block writes the output rows
// with threads across channels (coalesced).
//
// bf16_out (cfg.TPU.COMPUTE_DTYPE=bfloat16, the TPU kernel's out_dtype
// bfloat16) keeps the f32 weights and sums and rounds each output to bf16
// (round to nearest even) as it is stored: half the output bytes.
//
// Kernel 8 replaces the TPU kernel three_nn_pallas.py:_window_interp_kernel
// (wrapper three_interpolate_window_pallas, interpolate_features(
// sorted_z=True)): the same function for clouds sorted ascending by z, with
// the neighbours' indices and d2 written out on request. It runs kernel 4's
// kernel, the staged search, with those two outputs and with the chunk
// bounds read in place: on a known cloud sorted by z each chunk's first and
// last z are its z range, so kernel 8 needs no pre-pass and no workspace,
// and its result equals kernel 4's (and kernel 7's neighbours) bit for bit.
// On a known cloud that is not sorted, the first and last z bound nothing
// and the search may skip a chunk that holds a neighbour: kernel 8 then
// returns three known points and their d2, not always the nearest (the
// TPU kernel too assumes sorted clouds). The ring walk it replaces (a
// thread a query, a serial binary search, then a two-sided walk of
// dependent global loads) took 0.646 ms on an H100 over the inference
// batch's four FP launches against kernel 4's 0.369 (PERF.md);
// It was measured against this launch and against kernel 4's, the
// pre-pass included (PERF.md §6).
#include <stdint.h>

#include <algorithm>

#include "search.cuh"

namespace {

constexpr int kQ = kNNThreads;  // threads a block
constexpr int kInterpMinBlocks = 8;  // kernel 4's launch bound: blocks an SM

// x rounded to bf16 (round to nearest even), as its 16 bits
__device__ __forceinline__ unsigned short bf16_rn(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return h;
}

// Kernels 4 and 8: a block takes 128 * kQPT consecutive unknown points of
// one batch row and channels [split * cg, split * cg + cg) of their output,
// cg = ceil(C / csplit), split = blockIdx.x % csplit; the blocks of split 0
// write the neighbours' indices and d2 to idx_out and d2_out where those are
// not null (kernel 8). kSortedEnds (kernel 8): the chunk bounds are each
// chunk's first and last z, read in place (SortedChunkEnds; `bounds` is not
// read), which bound the chunks only on known clouds sorted by z.
// kBF16Out: out holds bf16, each f32 sum rounded to nearest even.
template <int kQPT, int kMinBlocks, bool kSortedEnds = false,
          bool kBF16Out = false>
__global__ void __launch_bounds__(kQ, kMinBlocks)
three_interp_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known,
                    const float2* __restrict__ bounds,
                    const float* __restrict__ feats, int n, int m, int C,
                    int csplit, int a16, void* __restrict__ out,
                    int* __restrict__ idx_out, float* __restrict__ d2_out) {
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
  const float* kb = known + (size_t)b * m * 3;
  if constexpr (kSortedEnds)
    staged_three_nn<kQPT>(unknown + (size_t)b * n * 3, n, u0, kb, m,
                          SortedChunkEnds{kb, m}, a16 != 0, d, nn);
  else
    staged_three_nn<kQPT>(unknown + (size_t)b * n * 3, n, u0, kb, m,
                          bounds + (size_t)b * n_chunks(m), a16 != 0, d, nn);

#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const float r0 = 1.0f / (d[i][0] + 1e-8f), r1 = 1.0f / (d[i][1] + 1e-8f),
                r2 = 1.0f / (d[i][2] + 1e-8f);
    const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
    const int q = tid * kQPT + i;
    if (idx_out != nullptr && split == 0 && u0 + q < n) {
      const size_t o = ((size_t)b * n + u0 + q) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        idx_out[o + k] = nn[i][k];
        d2_out[o + k] = d[i][k];
      }
    }
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
    const size_t o = ((size_t)b * n + u0 + q) * C + c;
    if constexpr (kBF16Out)
      static_cast<unsigned short*>(out)[o] = bf16_rn(v);
    else
      static_cast<float*>(out)[o] = v;
  }
}

// Launches kernel 4 (kernel 8: kSortedEnds, idx_out and d2_out; a bf16
// output: kBF16Out) with kQPT queries a thread, registers for kMinBlocks
// blocks an SM and csplit channel groups, after the pre-pass unless
// kSortedEnds; returns a cudaError_t.
template <int kQPT, int kMinBlocks, bool kSortedEnds = false,
          bool kBF16Out = false>
int launch_three_interp(int csplit, const float* unknown, const float* known,
                        const float* feats, int B, int n, int m, int C,
                        void* out, float2* bounds, cudaStream_t st,
                        int* idx_out = nullptr, float* d2_out = nullptr) {
  if constexpr (!kSortedEnds) {
    const int err = launch_chunk_bounds(known, B, m, bounds, st);
    if (err) return err;
  }
  const int a16 =
      (reinterpret_cast<uintptr_t>(known) & 15) == 0 && m % 4 == 0 ? 1 : 0;
  const long long blocks = (long long)B * ((n + kQ * kQPT - 1) / (kQ * kQPT));
  three_interp_kernel<kQPT, kMinBlocks, kSortedEnds, kBF16Out>
      <<<(unsigned)(blocks * csplit), kQ, 0, st>>>(
          unknown, known, bounds, feats, n, m, C, csplit, a16, out, idx_out,
          d2_out);
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

// The library's channel groups for kernels 4 and 8 on the current device
// (three_interp_splits with one query a thread) into *csplit; returns a
// cudaError_t.
int library_splits(int B, int n, int m, int C, int* csplit) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err) *csplit = three_interp_splits(1, B, n, m, C, sms);
  return err;
}

}  // namespace

// unknown (B, n, 3), known (B, m, 3), feats (B, m, C) f32 -> out (B, n, C),
// f32 (bf16_out 0) or bf16 (1); bounds a workspace of B * n_chunks(m)
// float2 (the pre-pass writes it).
WS3D_EXPORT int ws3d_three_interpolate(const float* unknown, const float* known,
                                       const float* feats, int B, int n, int m,
                                       int C, void* out, void* bounds,
                                       int bf16_out, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || C <= 0 || (bf16_out != 0 && bf16_out != 1))
    return (int)cudaErrorInvalidValue;
  int csplit = 1;
  const int err = library_splits(B, n, m, C, &csplit);
  if (err) return err;
  if (bf16_out)
    return launch_three_interp<1, kInterpMinBlocks, false, true>(
        csplit, unknown, known, feats, B, n, m, C, out, (float2*)bounds,
        (cudaStream_t)stream);
  return launch_three_interp<1, kInterpMinBlocks>(
      csplit, unknown, known, feats, B, n, m, C, out, (float2*)bounds,
      (cudaStream_t)stream);
}

// Kernel 8: the same contract for known points sorted ascending by z (see
// above for any other cloud), no workspace; idx_out and d2_out ((B, n, 3)
// int32 / f32, or both null) receive the neighbours and their d2.
WS3D_EXPORT int ws3d_three_interpolate_window(const float* unknown,
                                              const float* known,
                                              const float* feats, int B, int n,
                                              int m, int C, float* out,
                                              int* idx_out, float* d2_out,
                                              void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || C <= 0 ||
      (idx_out == nullptr) != (d2_out == nullptr))
    return (int)cudaErrorInvalidValue;
  int csplit = 1;
  const int err = library_splits(B, n, m, C, &csplit);
  if (err) return err;
  return launch_three_interp<1, kInterpMinBlocks, true>(
      csplit, unknown, known, feats, B, n, m, C, out, nullptr,
      (cudaStream_t)stream, idx_out, d2_out);
}
