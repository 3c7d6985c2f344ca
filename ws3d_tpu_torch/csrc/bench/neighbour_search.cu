// The measurement behind the staged, pruned searches of kernels 6
// (csrc/ball_query.cu) and 4 (csrc/interpolate.cu): each against the
// index-order search it replaced, at every launch shape of the main path,
// on z-sorted clouds and on the same clouds shuffled.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -Xcompiler -ffp-contract=off -o neighbour_search \
//       ws3d_tpu_torch/csrc/bench/neighbour_search.cu && ./neighbour_search
//
// Shapes: kernel 6 at the stage-1 train step's four SA stages (16 scenes)
// and the RCNN step's three backward stages (800 crops); kernel 4 at the
// inference batch's four FP stages (16 scenes) and the database's FP0
// (one scene). Clouds are seeded and LiDAR-like (scenes: depth z in
// [0, 70] m biased to the near range, a ground layer and objects above it;
// crops: a 4 m disc of the same), sorted by z; the queries (kernel 6) and
// the known points (kernel 4) are every (N / M)-th point, so they stay
// sorted too. "shuffled" is the same points, queries and known points in a
// random order, where the z ranges of the chunks span the cloud and
// nothing is skipped. The old searches: kernel 6 as one warp a query over
// all points in ascending index (warp_ball_query), kernel 4 as one thread
// a query over every known point through shared-memory tiles
// (block_three_nn, which kernel 7 still runs). Each prints the CUDA-event
// time of both (mean of 5 launches after one warm-up; the new one with its
// pre-pass), the new one as the library launches it and with the other
// sizes it could take: kernel 6 with 1 and 4 queries a warp where it keeps
// 2; kernel 4 with launch bounds for 4 and 12 blocks an SM where it keeps
// 8, and with 2 and 4 queries a thread where it keeps 1. It exits 1 if
// any output differs from the old one by a bit, or if kernel 6's first row
// differs from a host ball query.
//
// Not part of the kernel library (csrc/*.cu only): it compiles
// ball_query.cu and interpolate.cu into itself.
#include <algorithm>
#include <array>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <random>
#include <vector>

#include "../ball_query.cu"
#include "../interpolate.cu"

namespace {

#define CHECK(x)                                                     \
  do {                                                               \
    const int e_ = (int)(x);                                         \
    if (e_) {                                                        \
      std::printf("%s:%d: %s\n", __FILE__, __LINE__,                 \
                  cudaGetErrorString((cudaError_t)e_));              \
      std::exit(1);                                                  \
    }                                                                \
  } while (0)

// Kernel 6's search before (and the fused SA's): one warp scans points
// [lo, hi) of `pts` ((x, y, z) rows) in ascending index, 32 at a time,
// computes each d2 once and tests it against every scale. rows[s] receives
// the first S[s] indices with d2 < r2[s], padded with the first hit, all 0
// when the ball is empty. The scan stops once every scale has its S hits.
__device__ __forceinline__ void warp_ball_query(
    const float* __restrict__ pts, int lo, int hi, float qx, float qy,
    float qz, const BallScales& sc, int* const* rows) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int cnt[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) cnt[s] = 0;
  bool full = false;
  for (int base = lo; base < hi && !full; base += 32) {
    const int j = base + lane;
    const float d = j < hi ? sqdist3(qx - pts[3 * j], qy - pts[3 * j + 1],
                                     qz - pts[3 * j + 2])
                           : __int_as_float(0x7f800000);
    full = true;
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s < sc.n) {  // warp-uniform
        const bool in = d < sc.r2[s];
        const unsigned m = __ballot_sync(0xffffffffu, in);
        const int rank = cnt[s] + __popc(m & below);
        if (in && rank < sc.S[s]) rows[s][rank] = j;
        cnt[s] += __popc(m);
        full = full && cnt[s] >= sc.S[s];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < sc.n) {
      const int n = min(cnt[s], sc.S[s]);
      const int first = n > 0 ? rows[s][0] : 0;
      for (int k = n + lane; k < sc.S[s]; k += 32) rows[s][k] = first;
    }
  }
  __syncwarp();
}

// kernel 6 before: one warp a query scans all N points in ascending index
__global__ void __launch_bounds__(256)
old_ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ new_xyz, int BM, int N, int M,
                      BallScales sc, BQOut o, int row_len) {
  extern __shared__ int srows[];  // 8 * row_len
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * 8 + warp;
  if (q >= BM) return;
  const int b = q / M;
  const float qx = new_xyz[3 * (size_t)q], qy = new_xyz[3 * (size_t)q + 1],
              qz = new_xyz[3 * (size_t)q + 2];
  int* rows[kMaxScales];
  int off = warp * row_len;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    rows[s] = srows + off;
    if (s < sc.n) off += sc.S[s];
  }
  warp_ball_query(xyz + (size_t)b * N * 3, 0, N, qx, qy, qz, sc, rows);
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < sc.n) {
      int* dst = o.out[s] + (size_t)q * sc.S[s];
      for (int k = lane; k < sc.S[s]; k += 32) dst[k] = rows[s][k];
    }
  }
}

// kernel 4 before: one thread a query, every known point, dense tiles
__global__ void __launch_bounds__(kNNThreads)
old_three_interp_kernel(const float* __restrict__ unknown,
                        const float* __restrict__ known,
                        const float* __restrict__ feats, int n, int m, int C,
                        float* __restrict__ out) {
  __shared__ float tile[3 * kNNTile];
  __shared__ int s_idx[kNNThreads][3];
  __shared__ float s_w[kNNThreads][3];
  const int tiles = (n + kNNThreads - 1) / kNNThreads;
  const int b = blockIdx.x / tiles;
  const int u0 = (blockIdx.x % tiles) * kNNThreads;
  const int tid = threadIdx.x;
  const int u = u0 + tid;
  const float* ub = unknown + (size_t)b * n * 3;
  const float* fb = feats + (size_t)b * m * C;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (u < n) {
    qx = ub[3 * u];
    qy = ub[3 * u + 1];
    qz = ub[3 * u + 2];
  }
  float d[3];
  int nn[3];
  block_three_nn(known + (size_t)b * m * 3, m, qx, qy, qz, tile, d, nn);
  const float r0 = 1.0f / (d[0] + 1e-8f), r1 = 1.0f / (d[1] + 1e-8f),
              r2 = 1.0f / (d[2] + 1e-8f);
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  for (int k = 0; k < 3; ++k) s_idx[tid][k] = nn[k];
  s_w[tid][0] = r0 / norm;
  s_w[tid][1] = r1 / norm;
  s_w[tid][2] = r2 / norm;
  __syncthreads();
  const int nu = min(kNNThreads, n - u0);
  for (int t = tid; t < nu * C; t += kNNThreads) {
    const int q = t / C, c = t - q * C;
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(fb[(size_t)s_idx[q][0] * C + c], s_w[q][0]),
                  __fmul_rn(fb[(size_t)s_idx[q][1] * C + c], s_w[q][1])),
        __fmul_rn(fb[(size_t)s_idx[q][2] * C + c], s_w[q][2]));
    out[((size_t)b * n + u0 + q) * C + c] = v;
  }
}

struct BQShape {
  const char* name;
  bool crop;
  int B, N, M, n_scales;
  float radius[2];
  int S[2];
};

const BQShape kBQShapes[] = {
    {"stage-1 SA0", false, 16, 16384, 4096, 2, {0.1f, 0.5f}, {16, 32}},
    {"stage-1 SA1", false, 16, 4096, 1024, 2, {0.5f, 1.0f}, {16, 32}},
    {"stage-1 SA2", false, 16, 1024, 256, 2, {1.0f, 2.0f}, {16, 32}},
    {"stage-1 SA3", false, 16, 256, 64, 2, {2.0f, 4.0f}, {16, 32}},
    {"RCNN SA0", true, 800, 512, 256, 1, {0.2f, 0.f}, {16, 0}},
    {"RCNN SA1", true, 800, 256, 128, 1, {0.4f, 0.f}, {32, 0}},
    {"RCNN SA2", true, 800, 128, 32, 1, {1.0f, 0.f}, {64, 0}},
};

struct FPShape {
  const char* name;
  int B, n, m, C;
};

const FPShape kFPShapes[] = {
    {"inference FP3", 16, 256, 64, 512},
    {"inference FP2", 16, 1024, 256, 512},
    {"inference FP1", 16, 4096, 1024, 256},
    {"inference FP0", 16, 16384, 4096, 128},
    {"database FP0", 1, 16384, 4096, 128},
};

// B rows of N LiDAR-like points sorted by z
std::vector<float> cloud(std::mt19937& gen, int B, int N, bool crop) {
  std::uniform_real_distribution<float> u(0.f, 1.f);
  std::normal_distribution<float> g(0.f, 1.f);
  std::vector<float> xyz((size_t)B * N * 3);
  std::vector<std::array<float, 3>> pts(N);
  for (int b = 0; b < B; ++b) {
    const float cz = crop ? 5.f + 60.f * u(gen) : 0.f;
    for (auto& p : pts) {
      float x, z;
      if (crop) {
        const float a = 6.2831853f * u(gen), r = 4.f * std::sqrt(u(gen));
        x = r * std::cos(a);
        z = cz + r * std::sin(a);
      } else {
        z = 70.f * u(gen) * u(gen) + 2.f;
        x = (u(gen) - 0.5f) * (0.2f + 1.4f * z);
      }
      const float y = u(gen) < 0.6f ? 1.7f + 0.05f * g(gen)
                                    : 1.7f - 2.f * u(gen);
      p = {x, y, z};
    }
    std::sort(pts.begin(), pts.end(),
              [](const auto& a, const auto& c) { return a[2] < c[2]; });
    for (int j = 0; j < N; ++j)
      for (int c = 0; c < 3; ++c) xyz[((size_t)b * N + j) * 3 + c] = pts[j][c];
  }
  return xyz;
}

// every (N / M)-th point of each row
std::vector<float> every(const std::vector<float>& xyz, int B, int N, int M) {
  std::vector<float> q((size_t)B * M * 3);
  for (int b = 0; b < B; ++b)
    for (int m = 0; m < M; ++m)
      for (int c = 0; c < 3; ++c)
        q[((size_t)b * M + m) * 3 + c] =
            xyz[((size_t)b * N + (size_t)m * (N / M)) * 3 + c];
  return q;
}

// each row's rows of `width` floats in a random order (the same order for
// `other`, if given)
void shuffle_rows(std::mt19937& gen, std::vector<float>& v, int B, int N,
                  int width, std::vector<float>* other = nullptr,
                  int owidth = 0) {
  std::vector<int> perm(N);
  for (int b = 0; b < B; ++b) {
    std::iota(perm.begin(), perm.end(), 0);
    std::shuffle(perm.begin(), perm.end(), gen);
    auto apply = [&](std::vector<float>& a, int w) {
      std::vector<float> row(a.begin() + (size_t)b * N * w,
                             a.begin() + (size_t)(b + 1) * N * w);
      for (int j = 0; j < N; ++j)
        std::memcpy(&a[((size_t)b * N + j) * w], &row[(size_t)perm[j] * w],
                    w * sizeof(float));
    };
    apply(v, width);
    if (other) apply(*other, owidth);
  }
}

template <class T>
T* to_device(const std::vector<T>& h) {
  T* p;
  CHECK(cudaMalloc(&p, h.size() * sizeof(T)));
  CHECK(cudaMemcpy(p, h.data(), h.size() * sizeof(T),
                   cudaMemcpyHostToDevice));
  return p;
}

template <class F>
float time_ms(F launch, cudaEvent_t e0, cudaEvent_t e1) {
  CHECK(launch());
  CHECK(cudaEventRecord(e0));
  for (int k = 0; k < 5; ++k) CHECK(launch());
  CHECK(cudaEventRecord(e1));
  CHECK(cudaEventSynchronize(e1));
  float ms = 0.f;
  CHECK(cudaEventElapsedTime(&ms, e0, e1));
  return ms / 5;
}

// row 0's first scale on the host, in the kernels' arithmetic
bool host_row0_ok(const std::vector<float>& xyz, const std::vector<float>& q,
                  const BQShape& s, float r2, const std::vector<int>& got) {
  const int S = s.S[0];
  for (int m = 0; m < s.M; ++m) {
    std::vector<int> hit;
    for (int j = 0; j < s.N && (int)hit.size() < S; ++j) {
      const float dx = q[3 * m] - xyz[3 * j];
      const float dy = q[3 * m + 1] - xyz[3 * j + 1];
      const float dz = q[3 * m + 2] - xyz[3 * j + 2];
      if ((dx * dx + dy * dy) + dz * dz < r2) hit.push_back(j);
    }
    for (int k = 0; k < S; ++k) {
      const int want = k < (int)hit.size() ? hit[k] : hit.empty() ? 0 : hit[0];
      if (got[(size_t)m * S + k] != want) return false;
    }
  }
  return true;
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

  for (const BQShape& s : kBQShapes) {
    std::vector<float> xyz = cloud(gen, s.B, s.N, s.crop);
    std::vector<float> q = every(xyz, s.B, s.N, s.M);
    for (int order = 0; order < 2; ++order) {
      if (order == 1) {
        shuffle_rows(gen, xyz, s.B, s.N, 3);
        shuffle_rows(gen, q, s.B, s.M, 3);
      }
      float* dxyz = to_device(xyz);
      float* dq = to_device(q);
      float r2[2];
      int* dout[2][2];
      BQOut o{};
      BallScales sc{};
      sc.n = s.n_scales;
      int row_len = 0;
      for (int k = 0; k < s.n_scales; ++k) {
        r2[k] = (float)((double)s.radius[k] * s.radius[k]);
        sc.r2[k] = r2[k];
        sc.S[k] = s.S[k];
        row_len += s.S[k];
        for (int v = 0; v < 2; ++v)
          CHECK(cudaMalloc(&dout[v][k], (size_t)s.B * s.M * s.S[k] * 4));
      }
      float2* dbounds;
      CHECK(cudaMalloc(&dbounds, (size_t)s.B * n_chunks(s.N) * 8));
      const int BM = s.B * s.M;
      auto old_launch = [&] {
        for (int k = 0; k < s.n_scales; ++k) o.out[k] = dout[0][k];
        old_ball_query_kernel<<<(BM + 7) / 8, 256, 8 * row_len * 4>>>(
            dxyz, dq, BM, s.N, s.M, sc, o, row_len);
        return (int)cudaGetLastError();
      };
      auto new_launch = [&] {
        void* outs[2] = {dout[1][0], dout[1][1]};
        return ws3d_ball_query(dxyz, dq, s.B, s.N, s.M, s.n_scales, r2, s.S,
                               outs, dbounds, nullptr);
      };
      auto same_as_old = [&](bool check_host) {
        bool same = true;
        for (int k = 0; k < s.n_scales; ++k) {
          const size_t cnt = (size_t)s.B * s.M * s.S[k];
          std::vector<int> a(cnt), b(cnt);
          CHECK(cudaMemcpy(a.data(), dout[0][k], cnt * 4,
                           cudaMemcpyDeviceToHost));
          CHECK(cudaMemcpy(b.data(), dout[1][k], cnt * 4,
                           cudaMemcpyDeviceToHost));
          same = same && a == b;
          if (k == 0 && check_host)
            same = same && host_row0_ok(xyz, q, s, r2[0], b);
        }
        return same;
      };
      const float t_old = time_ms(old_launch, e0, e1);
      const float t_new = time_ms(new_launch, e0, e1);
      const bool same = same_as_old(true);
      for (int k = 0; k < s.n_scales; ++k)
        CHECK(cudaMemset(dout[1][k], 0xff, (size_t)s.B * s.M * s.S[k] * 4));
      // the kept 2 queries a warp against 1 and 4
      BQOut o2{};
      for (int k = 0; k < s.n_scales; ++k) o2.out[k] = dout[1][k];
      const float t_q1 = time_ms([&] {
        return launch_ball_query<1>(dxyz, dq, s.B, s.N, s.M, sc, o2, row_len,
                                    dbounds, nullptr);
      }, e0, e1);
      const bool same1 = same_as_old(false);
      for (int k = 0; k < s.n_scales; ++k)
        CHECK(cudaMemset(dout[1][k], 0xff, (size_t)s.B * s.M * s.S[k] * 4));
      const float t_q4 = time_ms([&] {
        return launch_ball_query<4>(dxyz, dq, s.B, s.N, s.M, sc, o2, row_len,
                                    dbounds, nullptr);
      }, e0, e1);
      const bool same4 = same_as_old(false);
      std::printf("kernel 6 %s B%d N%d M%d %s: old %.4f ms, new %.4f ms "
                  "(%.2fx; queries a warp: 1 %.4f ms, 4 %.4f ms)%s%s\n",
                  s.name, s.B, s.N, s.M, order ? "shuffled" : "sorted", t_old,
                  t_new, t_old / t_new, t_q1, t_q4,
                  same ? "" : " FAIL: new != old or row 0 != host",
                  same1 && same4 ? "" : " FAIL: a sizing != old");
      ok = ok && same && same1 && same4;
      for (int k = 0; k < s.n_scales; ++k)
        for (int v = 0; v < 2; ++v) CHECK(cudaFree(dout[v][k]));
      for (void* p : {(void*)dxyz, (void*)dq, (void*)dbounds})
        CHECK(cudaFree(p));
    }
  }

  for (const FPShape& s : kFPShapes) {
    std::vector<float> un = cloud(gen, s.B, s.n, false);
    std::vector<float> kn = every(un, s.B, s.n, s.m);
    std::uniform_real_distribution<float> u(-1.f, 1.f);
    std::vector<float> feat((size_t)s.B * s.m * s.C);
    for (float& v : feat) v = u(gen);
    for (int order = 0; order < 2; ++order) {
      if (order == 1) {
        shuffle_rows(gen, un, s.B, s.n, 3);
        shuffle_rows(gen, kn, s.B, s.m, 3, &feat, s.C);
      }
      float* du = to_device(un);
      float* dk = to_device(kn);
      float* df = to_device(feat);
      const size_t n_out = (size_t)s.B * s.n * s.C;
      float *dold, *dnew;
      float2* dbounds;
      CHECK(cudaMalloc(&dold, n_out * 4));
      CHECK(cudaMalloc(&dnew, n_out * 4));
      CHECK(cudaMalloc(&dbounds, (size_t)s.B * n_chunks(s.m) * 8));
      auto old_launch = [&] {
        old_three_interp_kernel<<<s.B * ((s.n + kNNThreads - 1) / kNNThreads),
                                  kNNThreads>>>(du, dk, df, s.n, s.m, s.C,
                                                dold);
        return (int)cudaGetLastError();
      };
      auto new_launch = [&] {
        return ws3d_three_interpolate(du, dk, df, s.B, s.n, s.m, s.C, dnew,
                                      dbounds, nullptr);
      };
      const float t_old = time_ms(old_launch, e0, e1);
      const float t_new = time_ms(new_launch, e0, e1);
      std::vector<float> a(n_out), b(n_out);
      CHECK(cudaMemcpy(a.data(), dold, n_out * 4, cudaMemcpyDeviceToHost));
      auto same_as_old = [&] {
        CHECK(cudaMemcpy(b.data(), dnew, n_out * 4, cudaMemcpyDeviceToHost));
        return std::memcmp(a.data(), b.data(), n_out * 4) == 0;
      };
      bool same = same_as_old();
      const int sms = prop.multiProcessorCount;
      std::printf("kernel 4 %s B%d n%d m%d C%d %s: old %.4f ms, new %.4f ms "
                  "(%.2fx; %d channel groups",
                  s.name, s.B, s.n, s.m, s.C, order ? "shuffled" : "sorted",
                  t_old, t_new, t_old / t_new,
                  three_interp_splits(1, s.B, s.n, s.m, s.C, sms));
      // the kept sizing against other launch bounds and queries a thread
      auto variant = [&](const char* name, int v, auto launch) {
        const int cs = three_interp_splits(v, s.B, s.n, s.m, s.C, sms);
        CHECK(cudaMemset(dnew, 0xff, n_out * 4));
        const float tv = time_ms([&] { return launch(cs); }, e0, e1);
        const bool sv = same_as_old();
        same = same && sv;
        std::printf("; %s %.4f ms%s", name, tv, sv ? "" : " FAIL");
      };
      variant("4 blocks an SM", 1, [&](int cs) {
        return launch_three_interp<1, 4>(cs, du, dk, df, s.B, s.n, s.m, s.C,
                                         dnew, dbounds, nullptr);
      });
      variant("12 blocks an SM", 1, [&](int cs) {
        return launch_three_interp<1, 12>(cs, du, dk, df, s.B, s.n, s.m,
                                          s.C, dnew, dbounds, nullptr);
      });
      variant("2 queries a thread", 2, [&](int cs) {
        return launch_three_interp<2, 4>(cs, du, dk, df, s.B, s.n, s.m, s.C,
                                         dnew, dbounds, nullptr);
      });
      variant("4 queries a thread", 4, [&](int cs) {
        return launch_three_interp<4, 4>(cs, du, dk, df, s.B, s.n, s.m, s.C,
                                         dnew, dbounds, nullptr);
      });
      std::printf(")%s\n", same ? "" : " FAIL: new != old");
      ok = ok && same;
      for (void* p : {(void*)du, (void*)dk, (void*)df, (void*)dold,
                      (void*)dnew, (void*)dbounds})
        CHECK(cudaFree(p));
    }
  }
  std::printf("%s\n", ok ? "ok" : "FAIL");
  return ok ? 0 : 1;
}
