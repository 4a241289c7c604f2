// The shared body of the two resident shared-origin Woop kernels for Hopper
// (sm_90a): intersect_shared_culled.cu (B1) walks each 2048-ray tile's
// front-to-back cluster list; intersect_shared.cu (B6) walks every cluster
// in one front-to-back order shared by all tiles.
//
// Every ray of a batch starts at one origin (the camera, or a light for
// reversed shadow rays), so each triangle is pre-mapped by its Woop affine
// transform: o' = W (o - v0) is a per-triangle constant and a pair costs
// d' = W d plus a division-free in-triangle test, with the best hit carried
// as a rational (tn, dn = |d'_z|).
//
// The simple design: one thread per ray, 256 rays per block, grid
// (R / 256, B).  A cluster's 12 Woop rows are staged in shared memory and
// broadcast to all threads.  The block votes on each cluster's slab test
// against every ray's running best (__syncthreads_or) and skips it together;
// any-hit mode leaves the loop once every live ray of the block is blocked or
// dead (__syncthreads_and).  Dead rays (tmax < 0) never hit.  `tested`,
// unless null, gets each live ray's number of clusters whose faces its block
// tested (0 for a dead ray), the count that the pair-test bound of a launch
// is taken from.

#pragma once

#include <cuda_runtime.h>

namespace ff_shared {

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;
constexpr float kBig = 3.0e38f;
constexpr float kEpsBary = 1e-6f;

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

// kLists = true: `walk` holds lists (B, R / 2048, nc) and `counts`
// (B, R / 2048) the listed lengths.  kLists = false: `walk` holds one order
// (B, nc) of every cluster, `counts` is unused (null), and a block whose rays
// are all dead skips the loop.
template <bool kLists>
__global__ void __launch_bounds__(kThreads)
intersect_shared_kernel(const float* __restrict__ dirs, const float* __restrict__ tmax_in,
                        const float* __restrict__ woop, const float* __restrict__ boxes,
                        const int* __restrict__ walk, const int* __restrict__ counts,
                        float* __restrict__ out_t, int* __restrict__ out_prim,
                        int* __restrict__ tested, int R, int tpad, int nc, int chunk,
                        float t_min, int any_hit) {
  extern __shared__ float s_w[];  // [12][chunk]
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int n_tiles = R / kRayTile;
  const int tile = (blockIdx.x * kThreads) / kRayTile;
  const float* dir = dirs + (size_t)b * 3 * R;
  const float dx = dir[r], dy = dir[R + r], dz = dir[2 * R + r];
  const float tmax = tmax_in[(size_t)b * R + r];
  const bool dead = tmax < 0.0f;
  const float* w_b = woop + (size_t)b * 12 * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const int* list = kLists ? walk + ((size_t)b * n_tiles + tile) * nc : walk + (size_t)b * nc;
  int n_listed = nc;
  if (kLists) {
    n_listed = __ldg(counts + (size_t)b * n_tiles + tile);
  } else if (!any_hit && __syncthreads_and(dead)) {
    n_listed = 0;
  }
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);

  float btn = kBig, bdn = 1.0f;
  int bp = -1, n_tested = 0;
  for (int ci = 0; ci < n_listed; ++ci) {
    if (any_hit && __syncthreads_and(bp >= 0 || dead)) break;
    const int c = __ldg(list + ci);
    const float best_t = btn / bdn;
    const float t0x = __ldg(box_b + 0 * nc + c) * inv_dx;
    const float t1x = __ldg(box_b + 3 * nc + c) * inv_dx;
    const float t0y = __ldg(box_b + 1 * nc + c) * inv_dy;
    const float t1y = __ldg(box_b + 4 * nc + c) * inv_dy;
    const float t0z = __ldg(box_b + 2 * nc + c) * inv_dz;
    const float t1z = __ldg(box_b + 5 * nc + c) * inv_dz;
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), t_min));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), fminf(tmax, best_t)));
    if (!__syncthreads_or(tnear <= tfar)) continue;
    ++n_tested;

    for (int i = threadIdx.x; i < 12 * chunk; i += kThreads) {
      const int k = i / chunk, j = i - k * chunk;
      s_w[i] = __ldg(w_b + (size_t)k * tpad + (size_t)c * chunk + j);
    }
    __syncthreads();
    for (int j = 0; j < chunk; ++j) {
      const float w00 = s_w[0 * chunk + j], w01 = s_w[1 * chunk + j], w02 = s_w[2 * chunk + j];
      const float w10 = s_w[3 * chunk + j], w11 = s_w[4 * chunk + j], w12 = s_w[5 * chunk + j];
      const float w20 = s_w[6 * chunk + j], w21 = s_w[7 * chunk + j], w22 = s_w[8 * chunk + j];
      const float opx = s_w[9 * chunk + j], opy = s_w[10 * chunk + j], opz = s_w[11 * chunk + j];
      const float dpx = w00 * dx + w01 * dy + w02 * dz;
      const float dpy = w10 * dx + w11 * dy + w12 * dz;
      const float dpz = w20 * dx + w21 * dy + w22 * dz;
      const float sgn = dpz >= 0.0f ? 1.0f : -1.0f;
      const float dn = dpz * sgn;
      const float tn = -opz * sgn;
      const float u_n = opx * dn + tn * dpx;
      const float v_n = opy * dn + tn * dpy;
      const bool ok = dn > 1e-12f && u_n >= -kEpsBary * dn && v_n >= -kEpsBary * dn &&
                      u_n + v_n <= (1.0f + kEpsBary) * dn && tn > t_min * dn &&
                      tn < tmax * dn && tn * bdn < btn * dn;
      if (ok) {
        btn = tn;
        bdn = dn;
        bp = c * chunk + j;
      }
    }
    __syncthreads();
  }
  out_t[(size_t)b * R + r] = bp >= 0 ? btn / bdn : 0.0f;
  out_prim[(size_t)b * R + r] = bp;
  if (tested != nullptr) tested[(size_t)b * R + r] = dead ? 0 : n_tested;
}

// dirs (B, 3, R), tmax (B, R), woop (B, 12, tpad), boxes (B, 6, nc) shifted to
// the shared origin, walk and counts as for the kernel -> out_t, out_prim
// and, unless null, tested (B, R).  R must be a multiple of 2048 and
// tpad == nc * chunk.
template <bool kLists>
int launch_intersect_shared(const float* dirs, const float* tmax, const float* woop,
                            const float* boxes, const int* walk, const int* counts, float* out_t,
                            int* out_prim, int* tested, int B, int R, int tpad, int nc, int chunk,
                            float t_min, int any_hit, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (R % kRayTile != 0 || tpad != nc * chunk || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (walk == nullptr || (kLists && counts == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid(R / kThreads, B);
  const size_t smem = sizeof(float) * 12 * chunk;
  intersect_shared_kernel<kLists><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dirs, tmax, woop, boxes, walk, counts, out_t, out_prim, tested, R, tpad, nc, chunk, t_min,
      any_hit);
  return (int)cudaGetLastError();
}

}  // namespace ff_shared
