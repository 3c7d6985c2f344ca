// Rates behind the design of kernel 2's tensor-core MLP (csrc/fused_sa.cu):
// mma.sync m16n8k8 TF32 throughput with 16 independent accumulators a warp,
// and the rate of rounding f32 to TF32 with cvt.rna.tf32.f32 against the
// same rounding done with integer ops ((bits + 0x1000) & 0xffffe000), each
// in a loop that also does one xor and one f32 add per value.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tf32_split_rate \
//       ws3d_tpu_torch/csrc/bench/tf32_split_rate.cu && ./tf32_split_rate
//
// Not part of the kernel library (csrc/*.cu only).
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(b), "r"(b + 1));
}

__global__ void mma_loop(float* out, int iters) {
  float acc[16][4] = {};
  const uint32_t a = threadIdx.x, b = threadIdx.x * 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) mma(acc[j], a, b + j);
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool CVT>
__global__ void round_loop(float* out, int iters) {
  float x[16];
  for (int j = 0; j < 16; ++j) x[j] = threadIdx.x * 1.1f + j;
  uint32_t s = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t r;
      if (CVT)
        asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x[j]));
      else
        r = (__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u;
      s ^= r;
      x[j] += 1.0f;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = (float)s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 4 * 1024);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  float ms;
  for (int warps = 4; warps <= 16; warps *= 2) {
    mma_loop<<<sms * 2, 32 * warps>>>(out, 16);
    cudaEventRecord(e0);
    mma_loop<<<sms * 2, 32 * warps>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    const double flop = 2.0 * 16 * 8 * 8 * 16 * iters * sms * 2 * warps;
    printf("mma.sync m16n8k8 tf32, %d warps x %d blocks: %.3f ms, %.1f TFLOP/s\n",
           warps, sms * 2, ms, flop / ms / 1e9);
  }
  const double vals = 16.0 * iters * sms * 4 * 256;
  round_loop<true><<<sms * 4, 256>>>(out, 16);
  cudaEventRecord(e0);
  round_loop<true><<<sms * 4, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(&ms, e0, e1);
  printf("cvt.rna.tf32.f32 (+ xor, fadd): %.3f ms, %.1f G values/s an SM\n", ms,
         vals / ms / 1e6 / sms);
  round_loop<false><<<sms * 4, 256>>>(out, 16);
  cudaEventRecord(e0);
  round_loop<false><<<sms * 4, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(&ms, e0, e1);
  printf("integer rna (+ xor, fadd): %.3f ms, %.1f G values/s an SM\n", ms,
         vals / ms / 1e6 / sms);
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
