// X1: shared-origin Woop closest hit of the reference's matrix-unit
// experiment, for Hopper (sm_90a).
//
// Replaces experiments/intersect_mxu.py::intersect_mxu_shared (Pallas body
// `_kernel_mxu`), which the reference keeps beside the renderer, unwired.  On
// the TPU a block of 128 rays x 128 faces forms d' = W d as three K=8
// matmuls on the matrix unit.  Here one thread per ray forms the same three
// products with FP32 multiplies and adds in the kernel's body, on the CUDA
// cores: plain TF32 on the tensor cores would break the rule that geometry
// stays in full FP32.
//
// What decides the results, kept from the reference:
//   * a block is the reference's row block, 128 consecutive rays, and votes
//     on each cluster's slab test over all its rays (__syncthreads_or),
//     padding and dead rays included; t_min is clamped into tnear and tfar
//     has no tmax or running best, so the vote tests every cluster any of
//     the rays' lines passes, as the reference's does;
//   * clusters of 128 faces in index order, staged in shared memory; a pair
//     hits when t = -o'_z (1 / d'_z) (IEEE division: no fast math) and
//     u = o'_x + t d'_x, v = o'_y + t d'_y pass, with t_min < t < the running
//     best, so ties go to the lowest face id, as the reference's lane
//     reduction gives them;
//   * t_max after the scan: a miss (t = 0, prim = -1) unless the best t is
//     below it.  Any-hit is the same walk (the reference returns the closest
//     hit in both modes), so the C entry point does not take the flag.
// Degenerate and padding faces have all-zero rows: d'_z = 0, never a hit.
// Dead rays (tmax < 0) vote but skip the pair tests; they cannot hit.
// `tested`, unless null, gets each live ray's number of clusters its block
// tested (0 for a dead ray), the count the pair-test bound is taken from.
//
// What bounds it on this card: arithmetic, about 30 float operations per
// tested pair, one of them a division.  The per-variant Woop table stays in
// L2 and each tested cluster's 12 rows (6 KiB) are copied to shared memory,
// face-major, so a pair costs three broadcast 16-byte shared loads beside its
// arithmetic; device memory traffic is the directions in and (t, prim) out.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // rays per block: the reference's row block
constexpr int kChunk = 128;    // faces per cluster
constexpr float kBig = 3.0e38f;
constexpr float kEpsBary = 1e-6f;

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

__global__ void __launch_bounds__(kThreads)
intersect_mxu_kernel(const float* __restrict__ dirs, const float* __restrict__ tmax_in,
                     const float* __restrict__ woop, const float* __restrict__ boxes,
                     float* __restrict__ out_t, int* __restrict__ out_prim,
                     int* __restrict__ tested, int R, int nc, float t_min) {
  __shared__ __align__(16) float s_w[12 * kChunk];  // [face][12]
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const size_t tpad = (size_t)nc * kChunk;
  const float* dir = dirs + (size_t)b * 3 * R;
  const float dx = dir[r], dy = dir[R + r], dz = dir[2 * R + r];
  const float tmax = tmax_in[(size_t)b * R + r];
  const bool dead = tmax < 0.0f;
  const float* w_b = woop + (size_t)b * 12 * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);

  float best_t = kBig;
  int best_p = -1, n_tested = 0;
  for (int c = 0; c < nc; ++c) {
    const float t0x = __ldg(box_b + 0 * nc + c) * inv_dx;
    const float t1x = __ldg(box_b + 3 * nc + c) * inv_dx;
    const float t0y = __ldg(box_b + 1 * nc + c) * inv_dy;
    const float t1y = __ldg(box_b + 4 * nc + c) * inv_dy;
    const float t0z = __ldg(box_b + 2 * nc + c) * inv_dz;
    const float t1z = __ldg(box_b + 5 * nc + c) * inv_dz;
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), t_min));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    if (!__syncthreads_or(tnear <= tfar)) continue;
    ++n_tested;

    // Coalesced reads of the 12 rows, stored face-major: a face's 12 values
    // are then three 16-byte shared loads, broadcast to the block.
    for (int i = threadIdx.x; i < 12 * kChunk; i += kThreads) {
      const int k = i / kChunk, j = i - k * kChunk;
      s_w[j * 12 + k] = __ldg(w_b + (size_t)k * tpad + (size_t)c * kChunk + j);
    }
    __syncthreads();
    if (!dead) {
      const float4* s4 = reinterpret_cast<const float4*>(s_w);
      for (int j = 0; j < kChunk; ++j) {
        const float4 a = s4[3 * j], q = s4[3 * j + 1], e = s4[3 * j + 2];
        // a = (W0x, W0y, W0z, W1x), q = (W1y, W1z, W2x, W2y), e = (W2z, o'x, o'y, o'z)
        const float dp0 = a.x * dx + a.y * dy + a.z * dz;
        const float dp1 = a.w * dx + q.x * dy + q.y * dz;
        const float dp2 = q.z * dx + q.w * dy + e.x * dz;
        const float opx = e.y, opy = e.z, opz = e.w;
        const bool tiny = fabsf(dp2) < 1e-12f;
        const float invz = tiny ? 0.0f : 1.0f / dp2;
        const float t = -opz * invz;
        const float u = opx + t * dp0;
        const float v = opy + t * dp1;
        if (!tiny && u >= -kEpsBary && v >= -kEpsBary && u + v <= 1.0f + kEpsBary &&
            t > t_min && t < best_t) {
          best_t = t;
          best_p = c * kChunk + j;
        }
      }
    }
    __syncthreads();
  }
  const bool hit = best_p >= 0 && best_t < tmax;
  out_t[(size_t)b * R + r] = hit ? best_t : 0.0f;
  out_prim[(size_t)b * R + r] = hit ? best_p : -1;
  if (tested != nullptr) tested[(size_t)b * R + r] = dead ? 0 : n_tested;
}

}  // namespace

// dirs (B, 3, R), tmax (B, R), woop (B, 12, nc * 128) [W0, W1, W2, o'] and
// boxes (B, 6, nc) shifted to the shared origin -> out_t, out_prim and,
// unless null, tested (B, R).  R must be a multiple of 128.
extern "C" int ff_intersect_mxu_shared(const float* dirs, const float* tmax, const float* woop,
                                       const float* boxes, float* out_t, int* out_prim,
                                       int* tested, int B, int R, int nc, float t_min,
                                       void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (R % kThreads != 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(R / kThreads, B);
  intersect_mxu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dirs, tmax, woop, boxes, out_t, out_prim, tested, R, nc, t_min);
  return (int)cudaGetLastError();
}
