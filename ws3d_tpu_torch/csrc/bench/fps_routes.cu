// The measurement behind csrc/fps.cu's cut-over (kWarpMaxN): kernel 1's
// two designs at every FPS row class of the main path.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -Xcompiler -ffp-contract=off -o fps_routes \
//       ws3d_tpu_torch/csrc/bench/fps_routes.cu && ./fps_routes
//
// For each row class (R rows of N points -> npoint) it launches the plan
// ws3d_fps picks, then every route that takes the row (the warp route up to
// 1,024 points, the cluster route always), on R rows of seeded points whose
// second half repeats points of the first (ties across every slice border).
// It prints each route's plan and CUDA-event time (mean of 5 launches after
// one warm-up), and the host time of planning a cluster launch. It exits 1
// if a route's indices differ from the automatic route's, if row 0 differs
// from a host reference, or if a 16,384-point row class runs as a cluster
// of fewer than 8 CTAs.
//
// Not part of the kernel library (csrc/*.cu only): it compiles fps.cu into
// itself to reach the planning and launch routines behind ws3d_fps.
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "../fps.cu"

namespace {

struct RowClass {
  const char* path;
  int R, N, npoint;
};

// an inference batch of 16 scenes (backbone; the stage-2 trunk on 1,024
// crops and the cascade on 448), then a proposal-database scene (batch 1)
const RowClass kClasses[] = {
    {"inference backbone", 16, 16384, 4096},
    {"inference backbone", 16, 4096, 1024},
    {"inference backbone", 16, 1024, 256},
    {"inference backbone", 16, 256, 64},
    {"inference trunk", 1024, 512, 256},
    {"inference trunk", 1024, 256, 128},
    {"inference trunk", 1024, 128, 32},
    {"inference cascade", 448, 512, 256},
    {"inference cascade", 448, 256, 128},
    {"inference cascade", 448, 128, 32},
    {"database scene", 1, 16384, 4096},
    {"database scene", 1, 4096, 1024},
    {"database scene", 1, 1024, 256},
    {"database scene", 1, 256, 64},
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

std::vector<float> tie_cloud(std::mt19937& gen, int R, int N) {
  std::normal_distribution<float> normal(0.f, 10.f);
  std::vector<float> xyz((size_t)R * N * 3);
  for (int r = 0; r < R; ++r) {
    float* p = xyz.data() + (size_t)r * N * 3;
    const int half = N / 2;
    for (int i = 0; i < 3 * half; ++i) p[i] = normal(gen);
    std::uniform_int_distribution<int> pick(0, half - 1);
    for (int i = half; i < N; ++i) {
      const int j = pick(gen);
      for (int c = 0; c < 3; ++c) p[3 * i + c] = p[3 * j + c];
    }
  }
  return xyz;
}

// row 0 on the host, in the kernel's arithmetic (no contraction)
std::vector<int> host_fps(const float* p, int N, int npoint) {
  std::vector<float> md(N, 1e10f);
  std::vector<int> idx(npoint, 0);
  int last = 0;
  for (int it = 1; it < npoint; ++it) {
    float best = -1.f;
    int bi = 0;
    for (int i = 0; i < N; ++i) {
      const float dx = p[3 * i] - p[3 * last];
      const float dy = p[3 * i + 1] - p[3 * last + 1];
      const float dz = p[3 * i + 2] - p[3 * last + 2];
      const float d = (dx * dx + dy * dy) + dz * dz;
      if (d < md[i]) md[i] = d;
      if (md[i] > best) {
        best = md[i];
        bi = i;
      }
    }
    idx[it] = last = bi;
  }
  return idx;
}

double plan_us(int reps, int R, int N) {
  Plan plan;
  const auto t0 = std::chrono::steady_clock::now();
  for (int k = 0; k < reps; ++k) CHECK(cluster_plan(R, N, plan));
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::mt19937 gen(0);
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  bool ok = true;
  for (const RowClass& rc : kClasses) {
    const int R = rc.R, N = rc.N, np = rc.npoint;
    const std::vector<float> h = tie_cloud(gen, R, N);
    float *xyz, *coords;
    int* idx;
    CHECK(cudaMalloc(&xyz, h.size() * sizeof(float)));
    CHECK(cudaMalloc(&coords, (size_t)R * np * 3 * sizeof(float)));
    CHECK(cudaMalloc(&idx, (size_t)R * np * sizeof(int)));
    CHECK(cudaMemcpy(xyz, h.data(), h.size() * sizeof(float),
                     cudaMemcpyHostToDevice));
    std::vector<int> ref((size_t)R * np), got((size_t)R * np);
    CHECK(ws3d_fps(xyz, R, N, np, idx, coords, nullptr));
    CHECK(cudaMemcpy(ref.data(), idx, ref.size() * sizeof(int),
                     cudaMemcpyDeviceToHost));
    const std::vector<int> row0 = host_fps(h.data(), N, np);
    if (!std::equal(row0.begin(), row0.end(), ref.begin())) {
      std::printf("FAIL R%d N%d: row 0 differs from the host reference\n", R,
                  N);
      ok = false;
    }
    std::printf("%s R%d N%d->%d: auto %s;", rc.path, R, N, np,
                N <= kWarpMaxN ? "warp" : "cluster");
    for (int route = 0; route < 2; ++route) {
      Plan plan;
      if (route == 0) {
        if (N > kWarpMaxN) continue;   // a warp holds at most 1,024 points
        plan = warp_plan(N);
      } else {
        CHECK(cluster_plan(R, N, plan));
      }
      CHECK(launch_plan(plan, xyz, R, N, np, idx, coords, nullptr));
      CHECK(cudaMemcpy(got.data(), idx, got.size() * sizeof(int),
                       cudaMemcpyDeviceToHost));
      if (got != ref) {
        std::printf(" FAIL: %s route differs from auto;",
                    route ? "cluster" : "warp");
        ok = false;
      }
      CHECK(cudaEventRecord(e0));
      for (int k = 0; k < 5; ++k)
        CHECK(launch_plan(plan, xyz, R, N, np, idx, coords, nullptr));
      CHECK(cudaEventRecord(e1));
      CHECK(cudaEventSynchronize(e1));
      float ms = 0.f;
      CHECK(cudaEventElapsedTime(&ms, e0, e1));
      std::printf(" %s (C %d, %d threads x %d points) %.4f ms;",
                  route ? "cluster" : "warp", plan.C, plan.threads, plan.ppt,
                  ms / 5);
      if (route == 1 && N == 16384 && plan.C < 8) {
        std::printf(" FAIL: C %d < 8;", plan.C);
        ok = false;
      }
    }
    std::printf("\n");
    CHECK(cudaFree(xyz));
    CHECK(cudaFree(coords));
    CHECK(cudaFree(idx));
  }
  for (int R : {16, 1})
    std::printf("host: planning a cluster launch of R%d N16384 %.2f us\n", R,
                plan_us(100, R, 16384));
  std::printf("%s\n", ok ? "ok" : "FAILED");
  return ok ? 0 : 1;
}
