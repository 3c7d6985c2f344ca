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
// keeps it well below the tensor pipe's rate; wgmma (one instruction a 64 x
// N x 8 tile, B read from shared memory by the hardware) is the next step.
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
  const TCPlan p = plan_tc(C, M, S, d, feat);
  if (windowed)
    return launch_mode<kWindow>(bf16, p, xyz, feat, new_xyz, nullptr, B, P, C,
                                M, r2, S, d, params, out, (float2*)bounds,
                                stream);
  return launch_mode<kFull>(bf16, p, xyz, feat, new_xyz, nullptr, B, P, C, M,
                            r2, S, d, params, out, (float2*)bounds, stream);
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
