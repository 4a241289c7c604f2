// Throughput probe of single FP32 operations for Hopper (sm_90a).
//
// Replaces the vector-unit roof of tools/perf_probe.py::probe_roofline (the
// Pallas body `_vpu_kernel`): every element runs 64 rounds of
//   t1 = x * 0.501 + 0.499;  t2 = x * 0.502 + 0.498;
//   t3 = x * 0.497 + 0.503;  t4 = x * 0.5 + 0.5;
//   x = (t1 * t2 + t3 * t4) * 0.5
// in registers, 12 operations a round.  x = 1 is the rounds' fixed point and
// inputs in [0, 1) stay there, so the chain neither folds nor overflows.
// Literals are float: a double literal would promote the round to FP64.
//
// What bounds it on this card: operations.  It is built with --fmad=false,
// so each multiply and add executes alone (no FMA), rounds exactly like the
// plain PyTorch version's separate elementwise ops, and measures the rate of
// unfused FP32 operations that the intersection kernels' bounds divide by;
// 8 bytes an element against 768 operations leave device memory idle.  One
// thread per element: the four independent products of a round and the many
// resident warps hide each operation's latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 64;

__global__ void __launch_bounds__(kThreads)
vpu_probe_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = in[i];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const float t1 = x * 0.501f + 0.499f;
    const float t2 = x * 0.502f + 0.498f;
    const float t3 = x * 0.497f + 0.503f;
    const float t4 = x * 0.5f + 0.5f;
    x = (t1 * t2 + t3 * t4) * 0.5f;
  }
  out[i] = x;
}

}  // namespace

// in, out (n,) float32 -> out = 64 rounds of the product tree applied to in.
extern "C" int ff_vpu_probe(const float* in, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  vpu_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return (int)cudaGetLastError();
}
