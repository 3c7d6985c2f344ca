// Fused set abstraction: ball query + gather + BN-folded ReLU MLP + max-pool.
//
// One routine (fused_sa_tc_kernel) in three modes; it replaces three TPU
// kernels:
//   ws3d_tpu/ops/fused_sa_window_pallas.py:_kernel  (kWindow, kernel 2:
//                                                     z-sorted points, scan
//                                                     only the z-window of
//                                                     the query)
//   ws3d_tpu/ops/fused_sa_bq_pallas.py:_kernel      (kFull, kernel 3: rank
//                                                     search over all P
//                                                     points)
//   ws3d_tpu/ops/fused_sa_pallas.py:_kernel         (kGiven, kernel 9: the
//                                                     indices come from the
//                                                     caller)
// Semantics, all three: for each query the first S points with d2 < r2 in
// ascending index order, padded with the first hit, point 0 when the ball is
// empty (or, given, the S indices of its idx row); rows [xyz - q, feat] go
// through the MLP (ReLU after every layer) and are max-pooled over S. The
// TPU kernel of the given mode folds the centre into the first layer's bias;
// subtracting it from the row, as the other two modes do, is the same
// function.
//
// The modes differ only in where a query's indices come from, and that runs
// on the SIMT cores in exact f32. kFull and kWindow run kernel 6's staged
// search (block_ball_query, search.cuh): the launch's pre-pass writes the
// z range of each 32-point chunk, the block stages the chunks its queries
// may need through its activation buffers (free until the gather) with
// cp.async, and a warp skips a chunk whose z term reaches r2 for its query;
// hits are ranked in ascending index with ballot + popc and a query stops
// after S. On a z-sorted cloud that leaves the query's z slab, which is
// what kWindow's window was (a binary-searched z range at least r wide,
// holding every in-ball point), so the two modes share the search and
// kWindow needs no window argument; on any cloud the search is exact.
// kGiven copies the caller's row, clamped into [0, P). Geometry never
// enters a product. A block takes Q queries x Sp rows: Sp = S rounded up
// to 16, slots S..Sp-1 repeating slot 0 (duplicates leave the max
// unchanged), so every m16 tile is one query's rows.
//
// What bounds it on the H100: the MLP's FLOPs (2 * B*M*S * sum ci*co; ~1.7
// TFLOP per inference batch over the three modes' launches), far above the
// bytes it moves (the grouped tensor never reaches device memory). The MLP
// runs on the tensor cores, mma.sync m16n8k8 TF32 in three passes
// ("3xTF32"): each f32 operand x splits into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), and each product accumulates lo*hi + hi*lo + hi*hi in
// f32 (lo*lo dropped), about 22 mantissa bits, so the f32 tolerances of the
// port hold. The bound is 3x the MLP's FLOPs at 495 TFLOP/s.
//
// Design: at most 128 rows and 110 KB a block, so two blocks share an SM
// and one's search and gather overlap the other's MLP; a block too wide
// for that (Cin 515) takes its SM alone with up to 8 warps (plan_tc). Feature
// rows arrive by 16-byte cp.async (C % 4 == 0 and an aligned feat; scalar
// loads otherwise) into a [feat, xyz - q] layout; layer 0's weight rows are
// permuted to match. Activations ping-pong in shared memory with K padded
// to 8 (row strides = 4 mod 8, so A-fragment loads hit 32 distinct banks). A
// warp owns a 32 x 64 output tile (2 x 8 mma tiles, 64 accumulators); the
// block's warps take a layer's tiles in rounds, and each round streams the
// weight columns of its own tiles through shared memory in double-buffered
// k-chunks with cp.async (columns padded with zeros to whole 64-wide
// tiles). A warp's k loop is straight-line code (no guards: the rows and
// columns past the live ones are in the buffers and their results are
// dropped), loads the next step's fragments while it multiplies, and issues
// the three passes pass by pass so consecutive mma are independent. A k8
// step of a warp is 48 mma, 24 fragment loads and 24 splits of five
// integer/f32 operations: three issued instructions for each mma, which
// keeps it well below the tensor pipe's rate. The bf16 precisions of
// kernels 2 and 3 take a persistent wgmma route with the weights resident
// in shared memory wherever the widths let them fit (plan_resident, below
// launch_mode).
// The bf16 mode (PREC = kBF16; cfg.TPU.COMPUTE_DTYPE=bfloat16) rounds as the
// JAX package's XLA bf16 path does: every product's two factors (the
// centre-relative rows [feat, xyz - q] and the weights) rounded to bf16
// (round to nearest even) and summed in f32, with f32 bias, ReLU and max.
// The rounded-layer mode (PREC = kBF16Layers; the BN-free stacks in train
// mode) multiplies the same way and rounds each layer's output as flax's
// Dense(dtype=bfloat16) does: the f32 sum rounded to bf16, the bias rounded
// to bf16 and added, the sum rounded again, then ReLU, so every layer's
// output, the last one pooled, is bf16-valued (the composition whose VJP
// the backward takes: ops/fused_sa_idx.py).
// The TPU kernels round layer 0 otherwise: they store [xyz, feat] @ W0,
// absolute coordinates included, in bf16 and fold the centre into the bias
// in f32; their later layers round as here. That layer-0 rounding is not
// reproduced (ROADMAP.md queue 3).
// It keeps the k8 loop, the staging and the epilogue, and replaces the three
// passes with one mma.sync m16n8k8 bf16 (f32 accumulators) a tile: the f32
// fragments load as before and cvt.rn.bf16x2.f32 packs them, two to a
// register. bf16's k8 fragment holds columns 2t, 2t + 1 where TF32's holds
// t, t + 4; A and B are packed with the same pairing (t, t + 4), which only
// renumbers k, so the sum is the same. Its bound is the MLP's FLOPs at the
// dense bf16 rate (989 TFLOP/s), a sixth of the 3xTF32 bound. The search
// and the gather stay exact f32 in both modes.
//
// Bias + ReLU in the epilogue; the last layer max-pools each m16 tile in
// registers (rows g and g + 8, then __shfl_xor across the quad's row
// groups), and the Sp / 16 tile maxima of a query are combined with plain
// loads: no atomics.
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int kMaxLayers = 4;

enum Mode { kFull = 0, kWindow = 1, kGiven = 2 };

// queries a warp of the search (kFull, kWindow): Q * Sp rows with Sp >= 16
// fill at least Q / 2 warp tiles, and plan_tc gives a block at least that
// many warps (up to 4), so no warp takes more than 2 queries
constexpr int kSearchQW = 2;

// the MLP's precision: 3xTF32, bf16 factors (f32 bias, ReLU, max), or bf16
// factors with every layer's output rounded as flax's bf16 Dense rounds it
enum Prec { kTF32 = 0, kBF16 = 1, kBF16Layers = 2 };

struct MLPDesc {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = 3 + C, width[l + 1] = layer l out
};

// the packed weights' row pad (pack_params)
__host__ __device__ __forceinline__ int pad4(int c) { return (c + 3) & ~3; }
__host__ __device__ __forceinline__ int pad8(int c) { return (c + 7) & ~7; }

// The block's nq queries' indices, `row` slots each in idx: kGiven copies
// the first S from the caller's rows (gb, S a row) clamped into [0, P) (the
// wrapper's contract is that they already are; the clamp only keeps a bad
// one in bounds); kFull and kWindow take them from block_ball_query
// (search.cuh, kernel 6's search: chunks staged through `scratch`,
// kRingFloats floats of shared memory, and skipped by their z range, whose
// bounds the launch's pre-pass wrote). Slots S..row-1 repeat slot 0.
template <int MODE>
__device__ __forceinline__ void block_indices(const float* __restrict__ pb,
                                              int P, const float* qs, int nq,
                                              float r2, int S,
                                              const int* __restrict__ gb,
                                              const float2* __restrict__ bounds,
                                              int a16, float* scratch,
                                              int row, int* idx) {
  if constexpr (MODE == kGiven) {
    for (int t = threadIdx.x; t < nq * row; t += blockDim.x) {
      const int q = t / row, k = t - q * row;
      idx[t] = min(max(gb[(size_t)q * S + (k < S ? k : 0)], 0), P - 1);
    }
  } else {
    BallScales sc;
    sc.n = 1;
    sc.r2[0] = r2;
    sc.S[0] = S;
    BallRows rows;
    rows.base = idx;
    rows.stride = row;
    rows.off[0] = 0;
    block_ball_query<kSearchQW>(pb, P, bounds, a16 != 0, qs, nq, sc, rows,
                                ring_at(scratch));
    __syncthreads();
    for (int t = threadIdx.x; t < nq * (row - S); t += blockDim.x) {
      const int q = t / (row - S);
      idx[q * row + S + (t - q * (row - S))] = idx[q * row];
    }
  }
}

constexpr int kMT = 2;            // m16 tiles of a warp's output tile
constexpr int kNT = 8;            // n8 tiles of a warp's output tile
constexpr int kWarpRows = 16 * kMT;
constexpr int kTileCols = 8 * kNT;
constexpr int kTCWarps = 4;       // most warps of a block that shares its SM
constexpr int kTCMaxWarps = 8;    // most warps of a block alone on its SM
constexpr int kMaxRows = 128;     // most rows a block
constexpr size_t kTCSmem = 110 * 1024;        // two blocks an SM
constexpr size_t kSmemMax = 227 * 1024;       // one block an SM
constexpr size_t kWChunkBudget = 36 * 1024;   // both weight chunks

// Row stride of a layer input of width c: K padded to 8, plus 4, so that
// stride = 4 (mod 8) and the 32 lanes of an A-fragment load (rows g, columns
// t) hit 32 distinct banks.
__host__ __device__ __forceinline__ int act_stride(int c) { return pad8(c) + 4; }
// Columns of a layer's weights in whole warp tiles (64), so that the
// unguarded B loads of the last tile stay in zeros; a staged chunk's row
// stride adds 8, so that a B-fragment load (rows t, columns g) hits 32
// distinct banks.
__host__ __device__ __forceinline__ int w_cols(int n) {
  return (n + kTileCols - 1) / kTileCols * kTileCols;
}

struct TCLayout {
  int Sp;           // rows a query: S rounded up to 16
  int Q;            // queries a block
  int KC;           // weight rows a chunk of the widest layer's columns
  int bufA, bufB;   // floats a row of the two activation buffers
  int wchunk;       // floats of one staged weight chunk
  int feat_async;   // feature rows by 16-byte cp.async (C % 4 == 0, aligned)
};

// Floats at the front of a block's shared memory: its Q * Sp activation
// rows (rounded up to whole warp tiles) in both buffers; the search of
// kFull and kWindow stages its tiles there first, so at least kRingFloats.
__host__ __device__ __forceinline__ size_t act_floats(const TCLayout& lay) {
  const size_t rows =
      (lay.Q * lay.Sp + kWarpRows - 1) / kWarpRows * kWarpRows;
  const size_t f = rows * (lay.bufA + lay.bufB);
  return f > (size_t)kRingFloats ? f : (size_t)kRingFloats;
}

// rna_tf32(x): x rounded to the nearest TF32, ties away from zero, low 13
// bits 0: cvt.rna.tf32.f32's rounding, bit for bit on finite x, done with
// two integer ops (half a magnitude ulp added, then truncated), which run
// faster than cvt on its narrower conversion pipe
// (both measured on an H100)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32; x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// {lo, hi} rounded to bf16 (round to nearest even) and packed into one b32
// register, lo in the low half (the fragment element of the lower k)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// x rounded to bf16 (round to nearest even), back in f32
__device__ __forceinline__ float round_bf16(float x) {
  uint16_t h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return __uint_as_float((uint32_t)h << 16);
}

// one epilogue value: ReLU(acc + b), or in the rounded-layer mode
// ReLU(bf16(bf16(acc) + b)) with b already rounded to bf16
template <int PREC>
__device__ __forceinline__ float layer_out(float acc, float b) {
  if constexpr (PREC == kBF16Layers)
    return fmaxf(round_bf16(round_bf16(acc) + b), 0.f);
  return fmaxf(acc + b, 0.f);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Stage weight rows [k0, k0 + rows) and columns [c0, c0 + ncol) of a layer
// (kp4 rows of n columns, row-major in global memory) into Ws (row stride
// ns): rows past kp4 and columns past n are zeros. perm_c >= 0 reorders the
// first layer's rows to match [feat (perm_c), xyz] inputs: row k < perm_c
// takes global row k + 3, rows perm_c..perm_c + 2 take rows 0..2.
__device__ __forceinline__ void stage_weights(const float* __restrict__ wl,
                                              int kp4, int n, int c0,
                                              int ncol, int ns, int k0,
                                              int rows, int perm_c,
                                              float* Ws) {
  // element p = r * c4n + c4 of the chunk, stepped by blockDim.x without
  // a division in the loop
  const int c4n = ncol >> 2;
  const int dr = blockDim.x / c4n, dc = blockDim.x - dr * c4n;
  int r = threadIdx.x / c4n, c4 = threadIdx.x - r * c4n;
  while (r < rows) {
    int k = k0 + r;
    if (perm_c >= 0) k = k < perm_c ? k + 3 : k < perm_c + 3 ? k - perm_c : k;
    float* dst = Ws + r * ns + 4 * c4;
    const int col = c0 + 4 * c4;
    if (k < kp4 && col < n)
      cp_async16(dst, wl + (size_t)k * n + col);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    r += dr;
    c4 += dc;
    if (c4 >= c4n) {
      c4 -= c4n;
      ++r;
    }
  }
}

// The raw f32 A fragments (kMT m16 tiles; xa points at row g, column t of
// the first) and B fragments (kNT n8 tiles; wb points at row t, column g of
// the first) of one k8 step. No guards: rows past the live ones and columns
// past the layer's width are in the buffers, and their results are dropped,
// so the loop is straight-line code.
__device__ __forceinline__ void load_frags(const float* xa, int xs,
                                           const float* wb, int ns,
                                           float (&ra)[kMT][4],
                                           float (&rb)[kNT][2]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const float* xr = xa + 16 * mt * xs;
    ra[mt][0] = xr[0];                // row g,     column t
    ra[mt][1] = xr[8 * xs];           // row g + 8, column t
    ra[mt][2] = xr[4];                // row g,     column t + 4
    ra[mt][3] = xr[8 * xs + 4];       // row g + 8, column t + 4
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    rb[j][0] = wb[8 * j];             // row t,     column g
    rb[j][1] = wb[8 * j + 4 * ns];    // row t + 4, column g
  }
}

template <int MODE, int PREC>
__global__ void __launch_bounds__(32 * kTCMaxWarps, 1)
fused_sa_tc_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ feat,
                   const float* __restrict__ new_xyz,
                   const int* __restrict__ given, int P, int C, int M,
                   float r2, int S, TCLayout lay, MLPDesc desc,
                   const float2* __restrict__ bounds, int a16,
                   const float* __restrict__ params,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = desc.n_layers;
  const int cout = desc.width[L];
  const int Q = lay.Q, Sp = lay.Sp;
  const int R = (Q * Sp + kWarpRows - 1) / kWarpRows * kWarpRows;
  const int groups = (M + Q - 1) / Q;
  const int b = blockIdx.x / groups;
  const int q0 = (blockIdx.x % groups) * Q;
  const int nq = min(Q, M - q0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int g = lane >> 2, tg = lane & 3;

  // activation buffer l % 2 at smem + boff[l % 2] (offsets, not a pointer
  // array, so the compiler keeps shared-memory loads)
  const int boff[2] = {0, R * lay.bufA};
  // two weight chunks after the activations (or the search's ring)
  float* wbuf = smem + act_floats(lay);
  float* qs = wbuf + 2 * (size_t)lay.wchunk;
  int* idx = reinterpret_cast<int*>(qs + 3 * Q);

  const float* pb = xyz + (size_t)b * P * 3;
  const float* fb = feat + (size_t)b * P * C;
  for (int t = tid; t < nq * 3; t += nt)
    qs[t] = new_xyz[((size_t)b * M + q0) * 3 + t];
  __syncthreads();
  block_indices<MODE>(pb, P, qs, nq, r2, S,
                      MODE == kGiven ? given + ((size_t)b * M + q0) * S
                                     : nullptr,
                      MODE == kGiven ? nullptr
                                     : bounds + (size_t)b * n_chunks(P),
                      a16, smem, Sp, idx);
  __syncthreads();

  // gather rows [feat, xyz - q, zeros up to K8]
  const int Reff = nq * Sp;                     // a multiple of 16
  const int xs0 = act_stride(desc.width[0]);
  if (lay.feat_async) {
    // many 16-byte copies in flight while the xyz columns are written
    const int c4 = C >> 2;
    for (int t = tid; t < Reff * c4; t += nt) {
      const int r = t / c4, q4 = t - r * c4;
      cp_async16(smem + (size_t)r * xs0 + 4 * q4,
                 fb + (size_t)idx[r] * C + 4 * q4);
    }
    cp_async_commit();
  } else {
    for (int t = tid; t < Reff * C; t += nt) {
      const int r = t / C, c = t - r * C;
      smem[(size_t)r * xs0 + c] = fb[(size_t)idx[r] * C + c];
    }
  }
  const int tail = xs0 - C;
  for (int t = tid; t < Reff * tail; t += nt) {
    const int r = t / tail, c = t - r * tail;
    smem[(size_t)r * xs0 + C + c] =
        c < 3 ? pb[3 * idx[r] + c] - qs[3 * (r / Sp) + c] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const float* wp = params;
  for (int l = 0; l < L; ++l) {
    const int ci = desc.width[l], co = desc.width[l + 1];
    const int kp4 = pad4(ci), K8 = pad8(ci), n8 = pad8(co);
    const int xs = act_stride(ci), ys = act_stride(co);
    const float* wl = wp;
    const float* bias = wp + (size_t)kp4 * co;
    wp += (size_t)kp4 * co + co;
    const float* X = smem + ((l & 1) ? boff[1] : boff[0]);
    float* Y = smem + ((l & 1) ? boff[0] : boff[1]);
    const bool last = (l == L - 1);
    const int perm_c = l == 0 ? C : -1;
    const int RG = (Reff + kWarpRows - 1) / kWarpRows;   // row groups
    const int NTT = n8 >> 3;                    // n8 tiles
    const int items = RG * ((NTT + kNT - 1) / kNT);
    for (int base = 0; base < items; base += nwarps) {
      const int item = base + warp;
      const bool active = item < items;         // warp-uniform
      const int r0 = (item % RG) * kWarpRows;
      const int ct0 = (item / RG) * kNT;
      // the round's column tiles [cg0, cg1]: only their weights are staged,
      // in chunks as deep as the chunk buffer allows
      const int cg0 = base / RG, cg1 = (min(base + nwarps, items) - 1) / RG;
      const int c0 = cg0 * kTileCols;
      const int ncol = (cg1 - cg0 + 1) * kTileCols, ns = ncol + 8;
      const int KC = (lay.wchunk / ns) & ~7;
      const int nchunks = (K8 + KC - 1) / KC;
      float acc[kMT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

      stage_weights(wl, kp4, co, c0, ncol, ns, 0, min(KC, K8), perm_c,
                    wbuf);
      cp_async_commit();
      for (int c = 0; c < nchunks; ++c) {
        if (c + 1 < nchunks) {
          const int k1 = (c + 1) * KC;
          stage_weights(wl, kp4, co, c0, ncol, ns, k1, min(KC, K8 - k1),
                        perm_c, wbuf + ((c + 1) & 1) * (size_t)lay.wchunk);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
          const float* Ws = wbuf + (c & 1) * (size_t)lay.wchunk;
          const int k0 = c * KC;
          const int ksteps = min(KC, K8 - k0) >> 3;
          // the next step's fragments load while this step's multiply
          const float* xa = X + (size_t)(r0 + g) * xs + k0 + tg;
          const float* wb = Ws + tg * ns + (ct0 * 8 - c0) + g;
          float ra[kMT][4], rb[kNT][2];
          load_frags(xa, xs, wb, ns, ra, rb);
          for (int ks = 0; ks < ksteps; ++ks) {
            if constexpr (PREC != kTF32) {
              // fragments in bf16 (k pairs t, t + 4), then one mma a tile
              uint32_t a16[kMT][2], b16[kNT];
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) {
                a16[mt][0] = pack_bf16x2(ra[mt][0], ra[mt][2]);  // row g
                a16[mt][1] = pack_bf16x2(ra[mt][1], ra[mt][3]);  // g + 8
              }
#pragma unroll
              for (int j = 0; j < kNT; ++j)
                b16[j] = pack_bf16x2(rb[j][0], rb[j][1]);
              if (ks + 1 < ksteps)
                load_frags(xa + 8 * (ks + 1), xs, wb + 8 * (ks + 1) * ns, ns,
                           ra, rb);
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                for (int j = 0; j < kNT; ++j)
                  mma_bf16(acc[mt][j], a16[mt][0], a16[mt][1], b16[j]);
              continue;
            }
            uint32_t ahi[kMT][4], alo[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split_tf32(ra[mt][e], ahi[mt][e], alo[mt][e]);
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) split_tf32(rb[j][e], bh[j][e], bl[j][e]);
            if (ks + 1 < ksteps)
              load_frags(xa + 8 * (ks + 1), xs, wb + 8 * (ks + 1) * ns, ns,
                         ra, rb);
            // pass by pass, so that consecutive mma are independent; each
            // accumulator still takes lo*hi, hi*lo, hi*hi (small terms first)
#pragma unroll
            for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
                for (int j = 0; j < kNT; ++j) {
                  const uint32_t(&a)[4] = pass == 0 ? alo[mt] : ahi[mt];
                  const uint32_t(&b)[2] = pass == 1 ? bl[j] : bh[j];
                  mma_tf32(acc[mt][j], a, b[0], b[1]);
                }
              }
            }
          }
        }
        __syncthreads();
      }

      if (active) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (ct0 + j >= NTT) continue;
          const int col = (ct0 + j) * 8 + 2 * tg;
          // co % 4 == 0 and col is even: col < co implies col + 1 < co;
          // padded columns have zero weights and bias, so they stay 0
          float b0 = col < co ? __ldg(bias + col) : 0.f;
          float b1 = col < co ? __ldg(bias + col + 1) : 0.f;
          if constexpr (PREC == kBF16Layers) {
            b0 = round_bf16(b0);
            b1 = round_bf16(b1);
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const int r = r0 + 16 * mt;
            if (r >= Reff) continue;
            const float v0 = layer_out<PREC>(acc[mt][j][0], b0);
            const float v1 = layer_out<PREC>(acc[mt][j][1], b1);
            const float v2 = layer_out<PREC>(acc[mt][j][2], b0);
            const float v3 = layer_out<PREC>(acc[mt][j][3], b1);
            if (!last) {
              *reinterpret_cast<float2*>(Y + (size_t)(r + g) * ys + col) =
                  make_float2(v0, v1);
              *reinterpret_cast<float2*>(Y + (size_t)(r + g + 8) * ys + col) =
                  make_float2(v2, v3);
            } else {
              // max over the tile's 16 rows: g and g + 8 here, then the
              // eight row groups of the quad
              float m0 = fmaxf(v0, v2), m1 = fmaxf(v1, v3);
#pragma unroll
              for (int off = 4; off < 32; off <<= 1) {
                m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
                m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
              }
              if (g == 0 && col < co) {
                Y[(size_t)(r >> 4) * co + col] = m0;
                Y[(size_t)(r >> 4) * co + col + 1] = m1;
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // a query's Sp / 16 tile maxima (the last layer wrote them to its output
  // buffer, one row of cout a tile)
  const float* tmax = smem + ((L & 1) ? boff[1] : boff[0]);
  const int T = Sp >> 4;
  for (int t = tid; t < nq * cout; t += nt) {
    const int q = t / cout, c = t - q * cout;
    float m = tmax[(size_t)(q * T) * cout + c];
    for (int i = 1; i < T; ++i)
      m = fmaxf(m, tmax[(size_t)(q * T + i) * cout + c]);
    out[((size_t)b * M + q0) * cout + t] = m;
  }
}

struct TCPlan {
  TCLayout lay;
  int warps;        // warps a block
  size_t smem;      // bytes of dynamic shared memory a block
};

// Floats a row of a staged weight chunk of the widest layer
int tc_nsmax(const MLPDesc& d) {
  int ns = 8;
  for (int l = 1; l <= d.n_layers; ++l)
    ns = w_cols(d.width[l]) + 8 > ns ? w_cols(d.width[l]) + 8 : ns;
  return ns;
}

// Bytes of shared memory a block of layout lay takes: act_floats, two weight
// chunks, the queries and their indices
size_t tc_smem(const TCLayout& lay) {
  return sizeof(float) * (act_floats(lay) + 2 * (size_t)lay.wchunk +
                          3 * lay.Q + (size_t)lay.Q * lay.Sp);
}

// Warps a block of layout lay takes: one a 32 x 64 output tile of the
// widest layer, at most max_warps
int tc_warps(const TCLayout& lay, const MLPDesc& d, int max_warps) {
  const int RG = (lay.Q * lay.Sp + kWarpRows - 1) / kWarpRows;
  int warps = 1;
  for (int l = 1; l <= d.n_layers; ++l) {
    const int items = RG * (w_cols(d.width[l]) / kTileCols);
    warps = items > warps ? items : warps;
  }
  return warps < max_warps ? warps : max_warps;
}

// Sizes a launch from the shapes alone. Rows first: the most queries Q of
// Sp rows (at most kMaxRows rows) a block can take within kTCSmem, so that
// two blocks share an SM, with the shallowest weight chunks (8 rows of the
// widest layer's columns); a block that cannot share its SM even with one
// query takes up to kSmemMax and up to kTCMaxWarps warps instead. Then the
// chunks grow as deep as the rest allows (at most 32 rows, both within
// kWChunkBudget). Warps: tc_warps, at most kTCWarps when two blocks share
// an SM. It was timed against other sizings on an H100 (PERF.md §6).
TCPlan plan_tc(int C, int M, int S, const MLPDesc& d, const float* feat) {
  const int* widths = d.width;
  const int L = d.n_layers;
  TCPlan p;
  TCLayout& lay = p.lay;
  lay.Sp = (S + 15) & ~15;
  lay.feat_async =
      C % 4 == 0 && (reinterpret_cast<uintptr_t>(feat) & 15) == 0 ? 1 : 0;
  int buf[2] = {4, 4};    // layer l reads buffer l % 2
  for (int l = 0; l < L; ++l)
    buf[l & 1] = act_stride(widths[l]) > buf[l & 1] ? act_stride(widths[l])
                                                    : buf[l & 1];
  // the last layer writes one row of cout per 16 rows
  const int tile_rows = (widths[L] + 15) / 16;
  buf[L & 1] = tile_rows > buf[L & 1] ? tile_rows : buf[L & 1];
  lay.bufA = buf[0];
  lay.bufB = buf[1];
  const int nsmax = tc_nsmax(d);
  lay.KC = 8;
  lay.wchunk = lay.KC * nsmax;
  size_t cap = kTCSmem;
  int max_warps = kTCWarps;
  auto most_queries = [&] {
    lay.Q = 64;
    while (lay.Q > 1 && (lay.Q * lay.Sp > kMaxRows || lay.Q / 2 >= M ||
                         tc_smem(lay) > cap))
      lay.Q >>= 1;
  };
  most_queries();
  if (tc_smem(lay) > cap) {     // alone on its SM
    cap = kSmemMax;
    max_warps = kTCMaxWarps;
    most_queries();
  }
  while (lay.KC < 32) {
    TCLayout deeper = lay;
    deeper.KC *= 2;
    deeper.wchunk = deeper.KC * nsmax;
    if (tc_smem(deeper) > cap ||
        2 * sizeof(float) * (size_t)deeper.wchunk > kWChunkBudget)
      break;
    lay = deeper;
  }
  p.smem = tc_smem(lay);
  p.warps = tc_warps(lay, d, max_warps);
  return p;
}

// Launches mode MODE as planned in precision PREC; returns a cudaError_t.
template <int MODE, int PREC = kTF32>
int launch_fused_sa_tc(const TCPlan& p, const float* xyz, const float* feat,
                       const float* new_xyz, const int* given, int B, int P,
                       int C, int M, float r2, int S,
                       const MLPDesc& d, const float* params, float* out,
                       float2* bounds, void* stream) {
  if (reinterpret_cast<uintptr_t>(params) & 15)   // cp.async moves 16 bytes
    return (int)cudaErrorMisalignedAddress;
  if (p.smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // the search: the chunks' z ranges first (pre-pass)
  if (MODE != kGiven) {
    const int e =
        launch_chunk_bounds(xyz, B, P, bounds, (cudaStream_t)stream);
    if (e) return e;
  }
  const int a16 =
      (reinterpret_cast<uintptr_t>(xyz) & 15) == 0 && P % 4 == 0 ? 1 : 0;
  const int grid = B * ((M + p.lay.Q - 1) / p.lay.Q);
  const void* kernel = (const void*)fused_sa_tc_kernel<MODE, PREC>;
  int err = ws3d_set_smem(kernel, p.smem);
  // all of the SM's 228 KB to shared memory, so that two blocks fit
  if (!err)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err) return err;
  fused_sa_tc_kernel<MODE, PREC><<<grid, 32 * p.warps, p.smem,
                                   (cudaStream_t)stream>>>(
      xyz, feat, new_xyz, given, P, C, M, r2, S, p.lay, d, bounds, a16,
      params, out);
  return (int)cudaGetLastError();
}

// Checks the sizes and the widths (widths[0] = C + 3, every layer's width a
// positive multiple of 4) into d; returns a cudaError_t.
int make_desc(int B, int P, int C, int M, int S, int n_layers,
              const int* widths, MLPDesc& d) {
  if (B <= 0 || P <= 0 || M <= 0 || S <= 0 || n_layers < 1 ||
      n_layers > kMaxLayers || widths[0] != C + 3)
    return (int)cudaErrorInvalidValue;
  d.n_layers = n_layers;
  for (int l = 0; l <= kMaxLayers; ++l)
    d.width[l] = l <= n_layers ? widths[l] : 0;
  for (int l = 1; l <= n_layers; ++l)
    if (widths[l] <= 0 || widths[l] % 4) return (int)cudaErrorInvalidValue;
  return 0;
}

// Launches mode MODE as planned in the precision bf16 selects (0: 3xTF32,
// 1: bf16, 2: bf16 with rounded layers, kernels 2 and 3 only); returns a
// cudaError_t.
template <int MODE>
int launch_mode(int bf16, const TCPlan& p, const float* xyz,
                const float* feat, const float* new_xyz, const int* given,
                int B, int P, int C, int M, float r2, int S, const MLPDesc& d,
                const float* params, float* out, float2* bounds,
                void* stream) {
  if (bf16 == kBF16Layers) {
    if constexpr (MODE == kGiven) {
      return (int)cudaErrorInvalidValue;
    } else {
      return launch_fused_sa_tc<MODE, kBF16Layers>(p, xyz, feat, new_xyz,
                                                   given, B, P, C, M, r2, S,
                                                   d, params, out, bounds,
                                                   stream);
    }
  }
  if (bf16 != kTF32 && bf16 != kBF16) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_fused_sa_tc<MODE, kBF16>(p, xyz, feat, new_xyz, given,
                                                B, P, C, M, r2, S, d, params,
                                                out, bounds, stream)
              : launch_fused_sa_tc<MODE, kTF32>(p, xyz, feat, new_xyz, given,
                                                B, P, C, M, r2, S, d, params,
                                                out, bounds, stream);
}

// ---- the weight-stationary route: kernels 2 and 3 in bf16 -----------------
//
// The bf16 precisions of kernels 2 and 3 (kBF16, kBF16Layers) on stacks whose
// bf16 weights and tile buffers fit in one SM's shared memory (plan_resident
// decides, from the widths alone) take a persistent, warp-specialised
// kernel instead of fused_sa_tc_kernel, which stages every layer's f32
// weights again for each block of 64 rows:
//   - one block an SM (or one a tile, if fewer) walks the launch's tiles of
//     kResRows rows (Q = kResRows / Sp queries of one cloud) in a fixed
//     stride. At its start it stages every layer's weights once, converted
//     from pack_params' f32 buffer with the same cvt.rn the other route
//     applies on every k step, so the factors are the same values;
//   - two producer warpgroups, taking the tiles in turn, run the staged
//     search (block_ball_query on the warpgroup's own named barrier, its
//     ring in the buffer the tile will fill) and gather the rows
//     [feat, xyz - q] rounded to bf16 into one of two or three tile
//     buffers, the search and the subtraction exact f32 as before; an
//     mbarrier hands the tile over, another hands the buffer back, so the
//     next tiles' searches and gathers run under this tile's MLP;
//   - two consumer warpgroups, 64 rows each, run the MLP with wgmma bf16
//     (m64n128k16, or m64n64k16 for a 64-wide layer), A and B from shared
//     memory in the canonical K-major layout without swizzle (8 x 8 core
//     matrices of 16-byte rows, contiguous, so no K padding past 16) and
//     f32 accumulators in registers. A layer's epilogue (bias, ReLU, the
//     rounded-layer rounding on packed bf16 pairs) writes its output in
//     bf16 over the warpgroup's own rows of the tile buffer, which layer 0
//     has consumed, as the next layer's A. The last layer is max-pooled in
//     registers as the other route does and the Sp / 16 tile maxima of a
//     query combined through shared memory: no atomics.
// Every product's factors are the other route's, bit for bit (kBF16: each
// layer's f32 output rounded by the next layer as before; kBF16Layers: the
// outputs are bf16 values already); only the f32 sums group by k16 where
// the other route groups by k8. What bounds it on the H100 (PERF.md §6):
// no longer the MLP's FLOPs (about a fifth of its time at the bf16 peak)
// but the SIMT work around them, the epilogues and the searches, which
// share the SM's issue slots; the tensor cores wait on them.

constexpr int kResRows = 128;       // rows a tile
constexpr int kResConsumers = 2;    // consumer warpgroups, 64 rows each
constexpr int kResProducers = 2;    // producer warpgroups, tiles in turn
constexpr int kResThreads = 128 * (kResConsumers + kResProducers);
constexpr int kResN = 64;           // columns an accumulator chunk
constexpr int kResMidCols = 128;    // widest layer that feeds another
constexpr int kResLastCols = 256;   // widest last layer
constexpr int kResMaxQ = kResRows / 16;
constexpr int kResMaxStages = 3;    // tile buffers, as many as fit
constexpr uint32_t kResLBO = kResRows * 16;  // bytes a k8 column block
// named barriers: 0 is __syncthreads, 1 + p producer p's, then consumer
// w's
constexpr int kResProducerBar = 1;
constexpr int kResConsumerBar = 1 + kResProducers;

__host__ __device__ __forceinline__ int pad16(int c) { return (c + 15) & ~15; }
__host__ __device__ __forceinline__ int pad_n(int c) {
  return (c + kResN - 1) / kResN * kResN;
}

struct ResLayout {
  int Sp, Q;                 // rows a query (16, 32 or 64); queries a tile
  int k0;                    // layer 0's depth: C + 3 rounded up to 16
  int np[kMaxLayers];        // layer l's columns rounded up to kResN
  int w_off[kMaxLayers];     // bytes: layer l's bf16 weights
  int p_off[kMaxLayers];     // floats: layer l's weights in params
  int b_off[kMaxLayers];     // floats: layer l's bias in params
  int bias_s[kMaxLayers];    // floats: layer l's bias in shared memory
  int stages;                // tile buffers
  int in_off, in_bytes;      // bytes: the tile buffers
  int pool_off, idx_off, qs_off, bar_off, smem;   // bytes
};

// Whether kernels 2 and 3 take the weight-stationary route, and its shared
// memory: bf16 precisions only; at least two layers, each but the last at
// most kResMidCols wide, the last at most kResLastCols; Sp dividing 64, so
// that a query's rows lie in one consumer's 64; and every layer's bf16
// weights and f32 biases, two tile buffers (three where they fit), the
// pooled maxima, the indices and the barriers within kSmemMax. The one
// place that decides the route (ws3d_fused_sa launches it,
// ws3d_fused_sa_resident reports it).
bool plan_resident(int C, int S, int prec, const MLPDesc& d, ResLayout& lay) {
  const int L = d.n_layers;
  if ((prec != kBF16 && prec != kBF16Layers) || L < 2) return false;
  lay.Sp = (S + 15) & ~15;
  if (lay.Sp > 64 || 64 % lay.Sp) return false;
  lay.Q = kResRows / lay.Sp;
  lay.k0 = pad16(C + 3);
  size_t off = 0;
  int poff = 0, widest = lay.k0, boff = 0;
  for (int l = 0; l < L; ++l) {
    const int ci = d.width[l], co = d.width[l + 1];
    lay.np[l] = pad_n(co);
    if (lay.np[l] > (l + 1 < L ? kResMidCols : kResLastCols)) return false;
    if (l + 1 < L && lay.np[l] > widest) widest = lay.np[l];
    const int rows = l == 0 ? lay.k0 : lay.np[l - 1];
    lay.w_off[l] = (int)off;
    off += (size_t)rows * lay.np[l] * 2;
    lay.p_off[l] = poff;
    lay.b_off[l] = poff + pad4(ci) * co;
    poff = lay.b_off[l] + co;
    lay.bias_s[l] = boff;
    boff += lay.np[l];
    if (off > kSmemMax) return false;
  }
  // the biases (f32, padded with zeros to np)
  for (int l = 0; l < L; ++l) lay.bias_s[l] += (int)(off / sizeof(float));
  off += sizeof(float) * (size_t)boff;
  // a tile buffer holds the search's ring, then the gathered rows, then
  // each layer's output
  const size_t ring = sizeof(float) * (size_t)kRingFloats;
  size_t in = (size_t)kResRows * widest * 2;
  in = ((in > ring ? in : ring) + 127) & ~(size_t)127;
  lay.in_off = (int)off;
  lay.in_bytes = (int)in;
  const size_t rest =
      sizeof(float) * (kResRows / 16) * (size_t)lay.np[L - 1] +
      kResMaxStages * (sizeof(int) * kResRows + sizeof(float) * 3 * kResMaxQ) +
      2 * kResMaxStages * sizeof(uint64_t) + 8;
  for (lay.stages = kResMaxStages; lay.stages >= 2; --lay.stages)
    if (off + lay.stages * in + rest <= kSmemMax) break;
  if (lay.stages < 2) return false;
  off += lay.stages * in;
  lay.pool_off = (int)off;
  off += sizeof(float) * (kResRows / 16) * (size_t)lay.np[L - 1];
  lay.idx_off = (int)off;
  off += sizeof(int) * kResMaxStages * kResRows;
  lay.qs_off = (int)off;
  off += sizeof(float) * kResMaxStages * 3 * kResMaxQ;
  lay.bar_off = (int)((off + 7) & ~(size_t)7);
  off = lay.bar_off + 2 * kResMaxStages * sizeof(uint64_t);
  if (off > kSmemMax) return false;
  lay.smem = (int)off;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// arrive (release: this thread's earlier shared-memory writes are visible
// to a thread whose wait sees the phase complete)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed (acquire)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Producer warpgroup p as block_ball_query's team.
struct ProducerTeam {
  int p;
  __device__ __forceinline__ int rank() const {
    return threadIdx.x - 128 * (kResConsumers + p);
  }
  __device__ __forceinline__ int size() const { return 128; }
  __device__ __forceinline__ void sync() const {
    named_sync(kResProducerBar + p, 128);
  }
};

// A wgmma operand descriptor: K-major, no swizzle; lbo the bytes between
// core matrices along K, sbo between core matrices along M (or N)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads and writes of r across the
// asynchronous products that write it
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// d (+)= A (64 x 16) @ B (16 x 64), both from shared memory; d is
// overwritten when acc == 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// Eight values rounded to bf16 and packed, lowest k in the lowest half
__device__ __forceinline__ uint4 pack_bf16x8(const float (&x)[8]) {
  return make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]),
                    pack_bf16x2(x[4], x[5]), pack_bf16x2(x[6], x[7]));
}

// Every layer's weights into shared memory as bf16 (cvt.rn, as pack_bf16x2
// rounds them on the other route), B of layer l an np[l] x rows K-major
// tile: element (n, k) at (k / 8) * np * 16 + n * 16 + (k % 8) * 2 bytes.
// Rows past a layer's depth and columns past its width are zeros; layer
// 0's rows follow the [feat (C), xyz - q] inputs (pack_params keeps W0's
// rows in [xyz, feat] order).
__device__ __forceinline__ void stage_resident_weights(
    const float* __restrict__ params, int C, const MLPDesc& d,
    const ResLayout& lay, unsigned char* smem) {
  for (int l = 0; l < d.n_layers; ++l) {
    const int ci = d.width[l], co = d.width[l + 1], np = lay.np[l];
    const int nkb = (l == 0 ? lay.k0 : lay.np[l - 1]) >> 3;
    const float* wl = params + lay.p_off[l];
    unsigned char* ws = smem + lay.w_off[l];
    for (int it = threadIdx.x; it < nkb * np; it += blockDim.x) {
      const int kb = it / np, n = it - kb * np;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = kb * 8 + e;
        const int src = l > 0 ? (k < ci ? k : -1)
                        : k < C ? k + 3 : k < C + 3 ? k - C : -1;
        x[e] = src >= 0 && n < co ? wl[(size_t)src * co + n] : 0.f;
      }
      *reinterpret_cast<uint4*>(ws + (size_t)kb * np * 16 + n * 16) =
          pack_bf16x8(x);
    }
  }
}

// Producer p: for each kResProducers-th of the block's tiles from its p-th,
// the search and the gather into tile buffer k % stages once the consumers
// have handed it back.
__device__ __forceinline__ void resident_producer(
    const float* __restrict__ xyz, const float* __restrict__ feat,
    const float* __restrict__ new_xyz, int B, int P, int C, int M, float r2,
    int S, const ResLayout& lay, const float2* __restrict__ bounds, int a16,
    int fvec, unsigned char* smem, uint64_t* bars) {
  const ProducerTeam team{(int)(threadIdx.x / 128) - kResConsumers};
  const int r = team.rank();          // the row this thread gathers
  const int groups = (M + lay.Q - 1) / lay.Q, tiles = B * groups;
  const int nch = n_chunks(P), nkb = lay.k0 >> 3;
  const size_t kstride = (size_t)kResRows * 16;  // bytes a k8 column block
  for (int k = team.p, t = blockIdx.x + team.p * gridDim.x; t < tiles;
       k += kResProducers, t += kResProducers * gridDim.x) {
    const int stage = k % lay.stages, round = k / lay.stages;
    unsigned char* in = smem + lay.in_off + stage * lay.in_bytes;
    int* idx = reinterpret_cast<int*>(smem + lay.idx_off) + stage * kResRows;
    float* qs = reinterpret_cast<float*>(smem + lay.qs_off) +
                stage * 3 * kResMaxQ;
    if (round > 0) mbar_wait(&bars[kResMaxStages + stage], (round - 1) & 1);
    const int b = t / groups, q0 = (t - b * groups) * lay.Q;
    const int nq = min(lay.Q, M - q0);
    const float* pb = xyz + (size_t)b * P * 3;
    if (r < nq * 3) qs[r] = new_xyz[((size_t)b * M + q0) * 3 + r];
    team.sync();
    BallScales sc;
    sc.n = 1;
    sc.r2[0] = r2;
    sc.S[0] = S;
    BallRows rows;
    rows.base = idx;
    rows.stride = lay.Sp;
    rows.off[0] = 0;
    block_ball_query<kSearchQW>(pb, P, bounds + (size_t)b * nch, a16 != 0,
                                qs, nq, sc, rows,
                                ring_at(reinterpret_cast<float*>(in)), team);
    team.sync();
    const int pad = lay.Sp - S;
    for (int u = r; u < nq * pad; u += 128) {
      const int q = u / pad;
      idx[q * lay.Sp + S + (u - q * pad)] = idx[q * lay.Sp];
    }
    team.sync();
    // row r: [feat, xyz - q, zeros up to k0] in bf16; rows past the
    // tile's queries zeros
    unsigned char* dst = in + (size_t)r * 16;
    if (r < nq * lay.Sp) {
      const int p = idx[r];
      const float* fr = feat + ((size_t)b * P + p) * C;
      const float* q = qs + 3 * (r / lay.Sp);
      const float dx = pb[3 * p] - q[0], dy = pb[3 * p + 1] - q[1],
                  dz = pb[3 * p + 2] - q[2];
      int kb = 0;
      if (fvec) {
        const int nv = C >> 3;
#pragma unroll 8
        for (; kb < nv; ++kb) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(fr) + 2 * kb);
          const float4 c =
              __ldg(reinterpret_cast<const float4*>(fr) + 2 * kb + 1);
          *reinterpret_cast<uint4*>(dst + kb * kstride) = make_uint4(
              pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
              pack_bf16x2(c.x, c.y), pack_bf16x2(c.z, c.w));
        }
      }
      for (; kb < nkb; ++kb) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = kb * 8 + e;
          x[e] = c < C ? __ldg(fr + c)
                 : c == C ? dx : c == C + 1 ? dy : c == C + 2 ? dz : 0.f;
        }
        *reinterpret_cast<uint4*>(dst + kb * kstride) = pack_bf16x8(x);
      }
    } else {
      for (int kb = 0; kb < nkb; ++kb)
        *reinterpret_cast<uint4*>(dst + kb * kstride) = make_uint4(0, 0, 0, 0);
    }
    fence_async_shared();
    mbar_arrive(&bars[stage]);
  }
}

// max of two packed bf16 pairs, lane by lane (exact)
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two epilogue values of a layer packed in bf16, the lower column in the
// lower half: layer_out of (a0, b0) and (a1, b1) rounded to bf16 (in the
// rounded-layer mode they are bf16 values already: the f32 sum of the
// rounded accumulator and the rounded bias, rounded again, then the ReLU
// on the packed pair)
template <int PREC>
__device__ __forceinline__ uint32_t layer_pair(float a0, float a1, float b0,
                                               float b1) {
  if constexpr (PREC == kBF16Layers) {
    const uint32_t x = pack_bf16x2(a0, a1);
    return max_bf16x2(pack_bf16x2(__uint_as_float(x << 16) + b0,
                                  __uint_as_float(x & 0xffff0000u) + b1),
                      0u);
  }
  return pack_bf16x2(layer_out<PREC>(a0, b0), layer_out<PREC>(a1, b1));
}

// d (+)= A (64 x 16) @ B (16 x 128), both from shared memory, d[c] holding
// columns 64c .. 64c + 63 (the m64n128 accumulator is the two m64n64 ones
// in a row); d is overwritten when acc == 0
__device__ __forceinline__ void wgmma_ss128(float (&d)[2][32], uint64_t a,
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
        "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
        "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "l"(a), "l"(b), "r"(acc));
}

// nc (1 or 2) chunks of kResN columns of a layer: acc[c] = A @ B[:, chunk
// c] over ks k16 steps, A and B from shared memory (descriptors a and b,
// a_step and b_step bytes a k16 step); two chunks as one m64n128 product.
// Waits for the products.
__device__ __forceinline__ void resident_layer(float (&acc)[2][32], int nc,
                                               int ks, uint64_t a,
                                               uint32_t a_step, uint64_t b,
                                               uint32_t b_step) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(acc[c][i]);
  wgmma_fence();
  if (nc == 2) {
    for (int s = 0; s < ks; ++s)
      wgmma_ss128(acc, a + ((s * a_step) >> 4), b + ((s * b_step) >> 4),
                  s > 0);
  } else {
    for (int s = 0; s < ks; ++s)
      wgmma_ss(acc[0], a + ((s * a_step) >> 4), b + ((s * b_step) >> 4),
               s > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(acc[c][i]);
}

// A layer's epilogue in bf16 over the warp's 16 rows of the tile buffer
// (h: its row g, column block 0), the next layer's A: chunk c's n8 tile j
// holds columns 64c + 8j + 2t, + 1 of rows g and g + 8. bias: the layer's
// staged biases (resident_biases)
template <int PREC>
__device__ __forceinline__ void resident_store(
    const float (&acc)[2][32], int nc, const float* bias, int tq,
    unsigned char* h) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c >= nc) continue;
#pragma unroll
    for (int j = 0; j < kResN / 8; ++j) {
      const int col = c * kResN + 8 * j + 2 * tq;
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
      const float b0 = bb.x, b1 = bb.y;
      const float* v = acc[c] + 4 * j;
      unsigned char* dst = h + (size_t)(8 * c + j) * kResLBO + 4 * tq;
      *reinterpret_cast<uint32_t*>(dst) =
          layer_pair<PREC>(v[0], v[1], b0, b1);
      *reinterpret_cast<uint32_t*>(dst + 8 * 16) =
          layer_pair<PREC>(v[2], v[3], b0, b1);
    }
  }
}

// The last layer's epilogue: each warp's 16 rows max-pooled in registers
// (rows g and g + 8, then the quad's row groups) into pool[c0 + column]
template <int PREC>
__device__ __forceinline__ void resident_pool(const float (&acc)[2][32],
                                              int nc, int c0,
                                              const float* bias, int co,
                                              int g, int tq, float* pool) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c >= nc) continue;
#pragma unroll
    for (int j = 0; j < kResN / 8; ++j) {
      const int col = c0 + c * kResN + 8 * j + 2 * tq;
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
      const float b0 = bb.x, b1 = bb.y;
      const float* v = acc[c] + 4 * j;
      float m0, m1;
      if constexpr (PREC == kBF16Layers) {
        // bf16 values: the max of the packed pairs, one shuffle a step
        uint32_t m = max_bf16x2(layer_pair<PREC>(v[0], v[1], b0, b1),
                                layer_pair<PREC>(v[2], v[3], b0, b1));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          m = max_bf16x2(m, __shfl_xor_sync(0xffffffffu, m, off));
        m0 = __uint_as_float(m << 16);
        m1 = __uint_as_float(m & 0xffff0000u);
      } else {
        m0 = fmaxf(layer_out<PREC>(v[0], b0), layer_out<PREC>(v[2], b0));
        m1 = fmaxf(layer_out<PREC>(v[1], b1), layer_out<PREC>(v[3], b1));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
      }
      if (g == 0 && col < co) {
        pool[col] = m0;
        pool[col + 1] = m1;
      }
    }
  }
}

// A consumer warpgroup: rows [64 w, 64 w + 64) of each of the block's tiles
template <int PREC>
__device__ __forceinline__ void resident_consumer(
    int B, int M, const ResLayout& lay, const MLPDesc& d,
    float* __restrict__ out, unsigned char* smem, uint64_t* bars) {
  const int w = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int warp = wt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int L = d.n_layers, cout = d.width[L], npl = lay.np[L - 1];
  const int groups = (M + lay.Q - 1) / lay.Q, tiles = B * groups;
  const int T = lay.Sp >> 4;                  // m16 tiles a query
  const int bar = kResConsumerBar + w;
  const float* fsmem = reinterpret_cast<const float*>(smem);
  float* pool = reinterpret_cast<float*>(smem + lay.pool_off) +
                (size_t)4 * w * npl;          // [4 warps][npl]
  float acc[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  for (int k = 0, t = blockIdx.x; t < tiles; ++k, t += gridDim.x) {
    const int stage = k % lay.stages, round = k / lay.stages;
    const int b = t / groups, q0 = (t - b * groups) * lay.Q;
    const int nq = min(lay.Q, M - q0);
    // the warpgroup's 64 rows of the tile buffer (a ragged tile's rows past
    // its queries are zeros and run too: the products stay out of any
    // branch on the thread's rows)
    unsigned char* rows = smem + lay.in_off + stage * lay.in_bytes +
                          64 * w * 16;
    const uint64_t a_desc = wgmma_desc(rows, kResLBO, 128);
    mbar_wait(&bars[stage], round & 1);
    resident_layer(acc, lay.np[0] / kResN, lay.k0 >> 4, a_desc, 2 * kResLBO,
                   wgmma_desc(smem + lay.w_off[0], lay.np[0] * 16, 128),
                   2 * lay.np[0] * 16);
    for (int l = 1; l < L; ++l) {
      // layer l - 1's output over its input: every warp's products are
      // done, then the stores are made visible to the products that read
      // them
      named_sync(bar, 128);
      resident_store<PREC>(acc, lay.np[l - 1] / kResN,
                           fsmem + lay.bias_s[l - 1], tq,
                           rows + (16 * warp + g) * 16);
      fence_async_shared();
      named_sync(bar, 128);
      const int co = d.width[l + 1], ks = lay.np[l - 1] >> 4;
      const uint32_t b_lbo = lay.np[l] * 16;
      if (l + 1 < L) {
        resident_layer(acc, lay.np[l] / kResN, ks, a_desc, 2 * kResLBO,
                       wgmma_desc(smem + lay.w_off[l], b_lbo, 128),
                       2 * b_lbo);
        continue;
      }
      const float* bias = fsmem + lay.bias_s[l];
      for (int c0 = 0; c0 < lay.np[l]; c0 += 2 * kResN) {
        const int nc = min(2, (lay.np[l] - c0) / kResN);
        resident_layer(acc, nc, ks, a_desc, 2 * kResLBO,
                       wgmma_desc(smem + lay.w_off[l] + c0 * 16, b_lbo, 128),
                       2 * b_lbo);
        resident_pool<PREC>(acc, nc, c0, bias, co, g, tq,
                            pool + (size_t)warp * npl);
      }
    }
    mbar_arrive(&bars[kResMaxStages + stage]);  // the buffer is free
    named_sync(bar, 128);
    // a query's rows lie in this warpgroup's 64 (Sp divides 64): combine
    // its T tile maxima
    const int qa = min(nq, 64 * w / lay.Sp);
    const int qb = min(nq, (64 * w + 64) / lay.Sp);
    for (int u = wt; u < (qb - qa) * cout; u += 128) {
      const int q = qa + u / cout, c = u - (u / cout) * cout;
      const float* pr = pool + (size_t)(q * T - 4 * w) * npl + c;
      float m = pr[0];
      for (int i = 1; i < T; ++i) m = fmaxf(m, pr[(size_t)i * npl]);
      out[((size_t)b * M + q0 + q) * cout + c] = m;
    }
    named_sync(bar, 128);                     // pool free for the next tile
  }
}

template <int PREC>
__global__ void __launch_bounds__(kResThreads, 1)
fused_sa_resident_kernel(const float* __restrict__ xyz,
                         const float* __restrict__ feat,
                         const float* __restrict__ new_xyz, int B, int P,
                         int C, int M, float r2, int S, ResLayout lay,
                         MLPDesc desc, const float2* __restrict__ bounds,
                         int a16, int fvec, const float* __restrict__ params,
                         float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  // full[kResMaxStages] (a producer's 128 threads arrive), then
  // empty[kResMaxStages] (the consumers')
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  if (threadIdx.x < kResMaxStages) {
    mbar_init(&bars[threadIdx.x], 128);
    mbar_init(&bars[kResMaxStages + threadIdx.x], 128 * kResConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_resident_weights(params, C, desc, lay, smem);
  // the biases, zeros past each layer's width; in the rounded-layer mode
  // rounded to bf16 as the layer adds them
  for (int l = 0; l < desc.n_layers; ++l)
    for (int i = threadIdx.x; i < lay.np[l]; i += blockDim.x) {
      float v = i < desc.width[l + 1] ? params[lay.b_off[l] + i] : 0.f;
      if constexpr (PREC == kBF16Layers) v = round_bf16(v);
      reinterpret_cast<float*>(smem)[lay.bias_s[l] + i] = v;
    }
  fence_async_shared();
  __syncthreads();
  if (threadIdx.x >= 128 * kResConsumers)
    resident_producer(xyz, feat, new_xyz, B, P, C, M, r2, S, lay, bounds,
                      a16, fvec, smem, bars);
  else
    resident_consumer<PREC>(B, M, lay, desc, out, smem, bars);
}

// Launches the weight-stationary route (kernels 2 and 3: the same search
// either way) in precision PREC; returns a cudaError_t.
template <int PREC>
int launch_resident(const ResLayout& lay, const float* xyz, const float* feat,
                    const float* new_xyz, int B, int P, int C, int M,
                    float r2, int S, const MLPDesc& d, const float* params,
                    float* out, float2* bounds, void* stream) {
  int e = launch_chunk_bounds(xyz, B, P, bounds, (cudaStream_t)stream);
  if (e) return e;
  const int a16 =
      (reinterpret_cast<uintptr_t>(xyz) & 15) == 0 && P % 4 == 0 ? 1 : 0;
  const int fvec =
      C % 4 == 0 && (reinterpret_cast<uintptr_t>(feat) & 15) == 0 ? 1 : 0;
  int dev = 0, sms = 0;
  e = (int)cudaGetDevice(&dev);
  if (!e)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (e) return e;
  const long long tiles = (long long)B * ((M + lay.Q - 1) / lay.Q);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  const void* kernel = (const void*)fused_sa_resident_kernel<PREC>;
  e = ws3d_set_smem(kernel, (size_t)lay.smem);
  if (e) return e;
  fused_sa_resident_kernel<PREC><<<grid, kResThreads, lay.smem,
                                   (cudaStream_t)stream>>>(
      xyz, feat, new_xyz, B, P, C, M, r2, S, lay, d, bounds, a16, fvec,
      params, out);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, P, 3), feat (B, P, C), new_xyz (B, M, 3) f32; params packs
// [W0 (pad4(ci), co) row-major with zero rows past ci, b0 (co), W1, b1, ...]
// (BN folded; every co a multiple of 4; 16-byte aligned) -> out (B, M,
// width[n_layers]); bounds a workspace of B * n_chunks(P) float2 (the
// pre-pass writes it). windowed != 0 (kernel 2) is for xyz and new_xyz
// sorted ascending by z: there every in-ball point lies in the query's z
// window, and the search, the same as kernel 3's, gives the window's
// indices. bf16 = 1 runs the MLP in bf16 (f32 sums), 2 in bf16 with each
// layer's output rounded as flax's bf16 Dense rounds it, 0 in 3xTF32.
WS3D_EXPORT int ws3d_fused_sa(const float* xyz, const float* feat,
                              const float* new_xyz, int B, int P, int C, int M,
                              float r2, int S, int windowed, int bf16,
                              int n_layers, const int* widths,
                              const float* params, float* out, void* bounds,
                              void* stream) {
  MLPDesc d;
  const int err = make_desc(B, P, C, M, S, n_layers, widths, d);
  if (err) return err;
  if (bounds == nullptr) return (int)cudaErrorInvalidValue;
  ResLayout lay;
  if (plan_resident(C, S, bf16, d, lay))
    return bf16 == kBF16Layers
               ? launch_resident<kBF16Layers>(lay, xyz, feat, new_xyz, B, P,
                                              C, M, r2, S, d, params, out,
                                              (float2*)bounds, stream)
               : launch_resident<kBF16>(lay, xyz, feat, new_xyz, B, P, C, M,
                                        r2, S, d, params, out,
                                        (float2*)bounds, stream);
  const TCPlan p = plan_tc(C, M, S, d, feat);
  if (windowed)
    return launch_mode<kWindow>(bf16, p, xyz, feat, new_xyz, nullptr, B, P, C,
                                M, r2, S, d, params, out, (float2*)bounds,
                                stream);
  return launch_mode<kFull>(bf16, p, xyz, feat, new_xyz, nullptr, B, P, C, M,
                            r2, S, d, params, out, (float2*)bounds, stream);
}

// 1 if ws3d_fused_sa takes the weight-stationary route for these widths,
// S and precision bf16 (plan_resident), else 0.
WS3D_EXPORT int ws3d_fused_sa_resident(int C, int S, int bf16, int n_layers,
                                       const int* widths) {
  MLPDesc d;
  ResLayout lay;
  return make_desc(1, 1, C, 1, S, n_layers, widths, d) == 0 &&
                 plan_resident(C, S, bf16, d, lay)
             ? 1
             : 0;
}

// The same with the indices given: idx (B, M, S) int32, each in [0, P).
WS3D_EXPORT int ws3d_fused_sa_idx(const float* xyz, const float* feat,
                                  const float* new_xyz, const int* idx, int B,
                                  int P, int C, int M, int S, int n_layers,
                                  const int* widths, const float* params,
                                  float* out, int bf16, void* stream) {
  MLPDesc d;
  const int err = make_desc(B, P, C, M, S, n_layers, widths, d);
  if (err) return err;
  return launch_mode<kGiven>(bf16, plan_tc(C, M, S, d, feat), xyz, feat,
                             new_xyz, idx, B, P, C, M, 0.f, S, d, params, out,
                             nullptr, stream);
}
