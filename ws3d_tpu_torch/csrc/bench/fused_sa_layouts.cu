// The measurement behind csrc/fused_sa.cu's sizing (plan_tc): the fused
// SA's tensor-core routine at every launch shape of the main path, under
// the kept sizing and the others the shapes allow.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -Xcompiler -ffp-contract=off -o fused_sa_layouts \
//       ws3d_tpu_torch/csrc/bench/fused_sa_layouts.cu && ./fused_sa_layouts
//
// The shapes are the ten kernel-2 (windowed) and four kernel-3 (full)
// launches of an inference batch of 16 scenes (backbone; the stage-2 trunk
// on 1,024 crops and the cascade on 448) and kernel 9 (given) at an RCNN
// step's three stages (800 crops), on seeded clouds sorted by z whose balls
// hold about 2 S points. The sizings:
//   kept         plan_tc: rows first within 110 KB a block (two an SM),
//                <= 4 warps; a block that cannot share its SM takes up to
//                227 KB and up to 8 warps;
//   chunks first the former sizing: the deepest weight chunks first (up to 32
//                rows), then the most rows within 110 KB, <= 4 warps;
//   one/SM       kept's chunks, the most rows within 227 KB (one block an
//                SM), <= 4 warps;
//   one/SM 8w    the same with up to 8 warps.
// Each prints its layout and CUDA-event time (mean of 5 launches after one
// warm-up). For the searching modes it also times the given mode on the
// same rows (indices from a host ball query in the kernel's arithmetic):
// the difference is the search. It exits 1 if a sizing's output differs
// from the kept one's by a bit, or if a searching mode's output differs
// from the given mode's on the host's indices by a bit.
//
// Not part of the kernel library (csrc/*.cu only): it compiles fused_sa.cu
// into itself to reach the planning and launch routines behind
// ws3d_fused_sa.
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "../fused_sa.cu"

namespace {

struct Shape {
  const char* name;
  int mode;
  int B, P, M, C, S;
  float radius;
  int w[3];
};

const Shape kShapes[] = {
    {"backbone SA0 s0", kWindow, 16, 16384, 4096, 1, 16, 0.1f, {16, 16, 32}},
    {"backbone SA0 s1", kWindow, 16, 16384, 4096, 1, 32, 0.5f, {32, 32, 64}},
    {"backbone SA1 s0", kFull, 16, 4096, 1024, 96, 16, 0.5f, {64, 64, 128}},
    {"backbone SA1 s1", kFull, 16, 4096, 1024, 96, 32, 1.0f, {64, 96, 128}},
    {"backbone SA2 s0", kWindow, 16, 1024, 256, 256, 16, 1.0f,
     {128, 196, 256}},
    {"backbone SA2 s1", kWindow, 16, 1024, 256, 256, 32, 2.0f,
     {128, 196, 256}},
    {"backbone SA3 s0", kWindow, 16, 256, 64, 512, 16, 2.0f, {256, 256, 512}},
    {"backbone SA3 s1", kWindow, 16, 256, 64, 512, 32, 4.0f, {256, 384, 512}},
    {"trunk SA0", kWindow, 1024, 512, 256, 128, 16, 0.2f, {128, 128, 128}},
    {"trunk SA1", kWindow, 1024, 256, 128, 128, 32, 0.4f, {128, 128, 128}},
    {"trunk SA2", kFull, 1024, 128, 32, 128, 64, 1.0f, {128, 128, 256}},
    {"cascade SA0", kWindow, 448, 512, 256, 128, 16, 0.2f, {128, 128, 128}},
    {"cascade SA1", kWindow, 448, 256, 128, 128, 32, 0.4f, {128, 128, 128}},
    {"cascade SA2", kFull, 448, 128, 32, 128, 64, 1.0f, {128, 128, 256}},
    {"RCNN step SA0", kGiven, 800, 512, 256, 128, 16, 0.2f, {128, 128, 128}},
    {"RCNN step SA1", kGiven, 800, 256, 128, 128, 32, 0.4f, {128, 128, 128}},
    {"RCNN step SA2", kGiven, 800, 128, 32, 128, 64, 1.0f, {128, 128, 256}},
};

#define CHECK(x)                                                     \
  do {                                                               \
    const int e_ = (int)(x);                                         \
    if (e_) {                                                        \
      std::printf("%s:%d: %s\n", __FILE__, __LINE__,                 \
                  cudaGetErrorString((cudaError_t)e_));              \
      std::exit(1);                                                  \
    }                                                                \
  } while (0)

// the most queries (<= kMaxRows rows) within cap at lay's chunks
void most_queries(TCLayout& lay, int M, size_t cap) {
  lay.Q = 64;
  while (lay.Q > 1 && (lay.Q * lay.Sp > kMaxRows || lay.Q / 2 >= M ||
                       tc_smem(lay) > cap))
    lay.Q >>= 1;
}

TCPlan chunks_first(TCPlan p, const MLPDesc& d, int M) {
  TCLayout& lay = p.lay;
  const int nsmax = tc_nsmax(d);
  lay.KC = 32;
  while (lay.KC > 8 && 2 * sizeof(float) * lay.KC * nsmax > kWChunkBudget)
    lay.KC >>= 1;
  lay.wchunk = lay.KC * nsmax;
  most_queries(lay, M, kTCSmem);
  p.smem = tc_smem(lay);
  p.warps = tc_warps(lay, d, kTCWarps);
  return p;
}

TCPlan one_per_sm(TCPlan p, const MLPDesc& d, int M, int max_warps) {
  most_queries(p.lay, M, kSmemMax);
  p.smem = tc_smem(p.lay);
  p.warps = tc_warps(p.lay, d, max_warps);
  return p;
}

// bounds: the searching modes' chunk workspace, B * n_chunks(P) float2
int launch(int mode, const TCPlan& p, const float* xyz, const float* feat,
           const float* q, const int* idx, const Shape& s, float r2,
           const MLPDesc& d, const float* params, float* out,
           float2* bounds) {
  if (mode == kWindow)
    return launch_fused_sa_tc<kWindow>(p, xyz, feat, q, nullptr, s.B, s.P,
                                       s.C, s.M, r2, s.S, d, params, out,
                                       bounds, nullptr);
  if (mode == kFull)
    return launch_fused_sa_tc<kFull>(p, xyz, feat, q, nullptr, s.B, s.P, s.C,
                                     s.M, r2, s.S, d, params, out, bounds,
                                     nullptr);
  return launch_fused_sa_tc<kGiven>(p, xyz, feat, q, idx, s.B, s.P, s.C, s.M,
                                    0.f, s.S, d, params, out, nullptr,
                                    nullptr);
}

// the first S points of each query's ball in ascending index, padded with
// the first, 0 when empty: the kernels' arithmetic (no contraction)
std::vector<int> host_ball_query(const std::vector<float>& xyz,
                                 const std::vector<float>& q, const Shape& s,
                                 float r2) {
  std::vector<int> idx((size_t)s.B * s.M * s.S, 0);
  for (int b = 0; b < s.B; ++b)
    for (int m = 0; m < s.M; ++m) {
      const float* qq = q.data() + ((size_t)b * s.M + m) * 3;
      int* row = idx.data() + ((size_t)b * s.M + m) * s.S;
      int n = 0;
      for (int j = 0; j < s.P && n < s.S; ++j) {
        const float* pp = xyz.data() + ((size_t)b * s.P + j) * 3;
        const float dx = qq[0] - pp[0], dy = qq[1] - pp[1],
                    dz = qq[2] - pp[2];
        if ((dx * dx + dy * dy) + dz * dz < r2) row[n++] = j;
      }
      for (int k = n; k < s.S; ++k) row[k] = n ? row[0] : 0;
    }
  return idx;
}

template <class T>
T* to_device(const std::vector<T>& h) {
  T* p;
  CHECK(cudaMalloc(&p, h.size() * sizeof(T)));
  CHECK(cudaMemcpy(p, h.data(), h.size() * sizeof(T),
                   cudaMemcpyHostToDevice));
  return p;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::mt19937 gen(0);
  std::uniform_real_distribution<float> unif(0.f, 1.f);
  std::normal_distribution<float> normal(0.f, 1.f);
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  bool ok = true;
  for (const Shape& s : kShapes) {
    // a cube whose balls hold about 2 S points, sorted by z in each batch
    // row; every (P / M)-th point a query
    const double side = std::cbrt(s.P * 4.18879 * s.radius * s.radius *
                                  s.radius / (2.0 * s.S));
    std::vector<float> xyz((size_t)s.B * s.P * 3), q((size_t)s.B * s.M * 3);
    for (int b = 0; b < s.B; ++b) {
      std::vector<std::array<float, 3>> pts(s.P);
      for (auto& p : pts)
        for (float& v : p) v = (float)(unif(gen) * side);
      std::sort(pts.begin(), pts.end(),
                [](const auto& a, const auto& c) { return a[2] < c[2]; });
      for (int j = 0; j < s.P; ++j)
        for (int c = 0; c < 3; ++c)
          xyz[((size_t)b * s.P + j) * 3 + c] = pts[j][c];
      for (int m = 0; m < s.M; ++m)
        for (int c = 0; c < 3; ++c)
          q[((size_t)b * s.M + m) * 3 + c] =
              pts[(size_t)m * (s.P / s.M)][c];
    }
    std::vector<float> feat((size_t)s.B * s.P * s.C);
    for (float& v : feat) v = unif(gen);
    MLPDesc d;
    const int widths[4] = {s.C + 3, s.w[0], s.w[1], s.w[2]};
    CHECK(make_desc(s.B, s.P, s.C, s.M, s.S, 3, widths, d));
    std::vector<float> params;
    for (int l = 0; l < 3; ++l) {
      const int ci = widths[l], co = widths[l + 1];
      const float scale = std::sqrt(2.f / ci);
      for (int k = 0; k < pad4(ci); ++k)
        for (int c = 0; c < co; ++c)
          params.push_back(k < ci ? normal(gen) * scale : 0.f);
      for (int c = 0; c < co; ++c) params.push_back(0.1f * normal(gen));
    }
    const float r2 = (float)((double)s.radius * s.radius);
    std::vector<int> hidx;
    if (s.mode == kGiven) {
      std::uniform_int_distribution<int> pick(0, s.P - 1);
      hidx.resize((size_t)s.B * s.M * s.S);
      for (int& v : hidx) v = pick(gen);
    } else {
      hidx = host_ball_query(xyz, q, s, r2);
    }
    float* dxyz = to_device(xyz);
    float* dq = to_device(q);
    float* dfeat = to_device(feat);
    float* dparams = to_device(params);
    int* didx = to_device(hidx);
    const size_t n_out = (size_t)s.B * s.M * s.w[2];
    float* dout;
    CHECK(cudaMalloc(&dout, n_out * sizeof(float)));
    float2* dbounds;
    CHECK(cudaMalloc(&dbounds, (size_t)s.B * n_chunks(s.P) * sizeof(float2)));
    std::vector<float> ref(n_out), got(n_out);

    const TCPlan kept = plan_tc(s.C, s.M, s.S, d, dfeat);
    const TCPlan plans[4] = {kept, chunks_first(kept, d, s.M),
                             one_per_sm(kept, d, s.M, 4),
                             one_per_sm(kept, d, s.M, 8)};
    const char* names[4] = {"kept", "chunks first", "one/SM", "one/SM 8w"};
    std::printf("%s B%d P%d M%d C%d S%d %s:", s.name, s.B, s.P, s.M, s.C,
                s.S, s.mode == kWindow ? "window" : s.mode == kFull ? "full"
                                                                   : "given");
    auto time_plan = [&](int mode, const TCPlan& p) {
      CHECK(launch(mode, p, dxyz, dfeat, dq, didx, s, r2, d, dparams, dout,
                   dbounds));
      CHECK(cudaEventRecord(e0));
      for (int k = 0; k < 5; ++k)
        CHECK(launch(mode, p, dxyz, dfeat, dq, didx, s, r2, d, dparams, dout,
                     dbounds));
      CHECK(cudaEventRecord(e1));
      CHECK(cudaEventSynchronize(e1));
      float ms = 0.f;
      CHECK(cudaEventElapsedTime(&ms, e0, e1));
      CHECK(cudaMemcpy(got.data(), dout, n_out * sizeof(float),
                       cudaMemcpyDeviceToHost));
      return ms / 5;
    };
    for (int v = 0; v < 4; ++v) {
      const TCPlan& p = plans[v];
      const float ms = time_plan(s.mode, p);
      if (v == 0) ref = got;
      const bool same = std::memcmp(got.data(), ref.data(),
                                    n_out * sizeof(float)) == 0;
      std::printf(" %s (Q %d Sp %d KC %d, %d warps, %zu B) %.4f ms%s;",
                  names[v], p.lay.Q, p.lay.Sp, p.lay.KC, p.warps, p.smem, ms,
                  same ? "" : " FAIL: differs from kept");
      ok = ok && same;
    }
    if (s.mode != kGiven) {
      const float ms = time_plan(kGiven, kept);
      const bool same = std::memcmp(got.data(), ref.data(),
                                    n_out * sizeof(float)) == 0;
      std::printf(" given on the host's indices %.4f ms%s;", ms,
                  same ? "" : " FAIL: differs from the searching mode");
      ok = ok && same;
    }
    std::printf("\n");
    for (void* p : {(void*)dxyz, (void*)dq, (void*)dfeat, (void*)dparams,
                    (void*)didx, (void*)dout, (void*)dbounds})
      CHECK(cudaFree(p));
  }
  std::printf("%s\n", ok ? "ok" : "FAILED");
  return ok ? 0 : 1;
}
