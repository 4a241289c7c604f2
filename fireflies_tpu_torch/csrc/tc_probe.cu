// Probe of the tensor cores' TF32 sum for Hopper (sm_90a): one
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 a problem, accumulators
// starting at 0, the instruction X1 (csrc/intersect_mxu.cu) forms d' with.
//
// `perf_probe tc_sum` feeds it products designed to expose how the eight
// products of a k8 step are added: whether they are exact, how far below
// the largest one a product keeps its bits (the alignment window), and how
// the sum is rounded to float32, the terms of X1's tolerance
// (experiments/intersect_mxu.py, `sum_bound`).  One warp a problem; A is
// 16 x 8 row-major, B 8 x 8 as [k][n], D 16 x 8, all float32 holding TF32
// values (the low 13 bits of A and B are ignored by the instruction).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void tc_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ d, int n) {
  const int p = blockIdx.x;
  if (p >= n) return;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float* ap = a + (size_t)p * 128;
  const float* bp = b + (size_t)p * 64;
  const uint32_t a0 = __float_as_uint(ap[8 * g + t]), a1 = __float_as_uint(ap[8 * (g + 8) + t]);
  const uint32_t a2 = __float_as_uint(ap[8 * g + t + 4]);
  const uint32_t a3 = __float_as_uint(ap[8 * (g + 8) + t + 4]);
  const uint32_t b0 = __float_as_uint(bp[8 * t + g]), b1 = __float_as_uint(bp[8 * (t + 4) + g]);
  float d0, d1, d2, d3;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
  float* dp = d + (size_t)p * 128;
  dp[8 * g + 2 * t] = d0;
  dp[8 * g + 2 * t + 1] = d1;
  dp[8 * (g + 8) + 2 * t] = d2;
  dp[8 * (g + 8) + 2 * t + 1] = d3;
}

}  // namespace

// a (n, 16, 8), b (n, 8, 8) [k][n] float32 -> d (n, 16, 8) = a b, one
// TF32 mma.sync m16n8k8 a problem.
extern "C" int ff_tc_probe(const float* a, const float* b, float* d, int n, void* stream) {
  if (n <= 0) return 0;
  tc_probe_kernel<<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, d, n);
  return (int)cudaGetLastError();
}
