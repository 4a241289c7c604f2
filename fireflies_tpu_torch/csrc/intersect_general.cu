// General-origin ray/triangle closest-hit and any-hit for Hopper (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_kernel.py::intersect_pallas
// (Pallas body `_kernel`): Moller-Trumbore over Morton-ordered clusters of
// `chunk` faces, an AABB slab test per cluster that skips the cluster when no
// ray of the block can reach it closer than its current best hit, and the
// best hit carried as a rational (tn, dn = |det|) so the per-pair test needs
// no division.  Used for bounce rays (per-ray origins).
//
// What bounds it on this card: arithmetic, about 40 float operations per
// ray-triangle pair, with every ray of a block testing the same triangle
// rows.  Those rows (36 bytes a face) are read once per cluster into shared
// memory and then broadcast to all threads, so device memory traffic is the
// rays in and (t, prim) out; the triangle table of a variant (~50 KB at 1440
// faces) stays in L2.
//
// The simple design: one thread per ray, 256 rays per block, grid
// (R / 256, B) with one geometry per variant on the y axis.  The block votes
// on each cluster's slab test (__syncthreads_or) and skips it together; an
// all-dead block skips the loop (closest hit) and any-hit mode leaves the
// loop once every live ray is blocked (__syncthreads_and).  Dead rays
// (tmax < 0) never hit.  `tested`, unless null, gets each live ray's number
// of clusters whose faces its block tested (0 for a dead ray), the count that
// the pair-test bound of a launch is taken from.  Warp-level culling, persistent blocks and
// front-to-back cluster order are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;
constexpr float kEpsDet = 1e-9f;
constexpr float kEpsBary = 1e-6f;

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

__global__ void __launch_bounds__(kThreads)
intersect_general_kernel(const float* __restrict__ rays, const float* __restrict__ tmax_in,
                         const float* __restrict__ tri, const float* __restrict__ boxes,
                         float* __restrict__ out_t, int* __restrict__ out_prim,
                         int* __restrict__ tested, int R, int tpad, int nc, int chunk,
                         float t_min, int any_hit) {
  extern __shared__ float s_tri[];  // [9][chunk]
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const float* ray = rays + (size_t)b * 6 * R;
  const float ox = ray[r], oy = ray[R + r], oz = ray[2 * R + r];
  const float dx = ray[3 * R + r], dy = ray[4 * R + r], dz = ray[5 * R + r];
  const float tmax = tmax_in[(size_t)b * R + r];
  const bool dead = tmax < 0.0f;
  const float* tri_b = tri + (size_t)b * 9 * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);

  float btn = kBig, bdn = 1.0f;
  int bp = -1, n_tested = 0;
  const int n_eff = (!any_hit && __syncthreads_and(dead)) ? 0 : nc;
  for (int c = 0; c < n_eff; ++c) {
    if (any_hit && __syncthreads_and(bp >= 0 || dead)) break;
    const float best_t = btn / bdn;
    const float t0x = (__ldg(box_b + 0 * nc + c) - ox) * inv_dx;
    const float t1x = (__ldg(box_b + 3 * nc + c) - ox) * inv_dx;
    const float t0y = (__ldg(box_b + 1 * nc + c) - oy) * inv_dy;
    const float t1y = (__ldg(box_b + 4 * nc + c) - oy) * inv_dy;
    const float t0z = (__ldg(box_b + 2 * nc + c) - oz) * inv_dz;
    const float t1z = (__ldg(box_b + 5 * nc + c) - oz) * inv_dz;
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), t_min));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), fminf(tmax, best_t)));
    if (!__syncthreads_or(tnear <= tfar)) continue;
    ++n_tested;

    for (int i = threadIdx.x; i < 9 * chunk; i += kThreads) {
      const int k = i / chunk, j = i - k * chunk;
      s_tri[i] = __ldg(tri_b + (size_t)k * tpad + (size_t)c * chunk + j);
    }
    __syncthreads();
    for (int j = 0; j < chunk; ++j) {
      const float v0x = s_tri[0 * chunk + j], v0y = s_tri[1 * chunk + j], v0z = s_tri[2 * chunk + j];
      const float e1x = s_tri[3 * chunk + j], e1y = s_tri[4 * chunk + j], e1z = s_tri[5 * chunk + j];
      const float e2x = s_tri[6 * chunk + j], e2y = s_tri[7 * chunk + j], e2z = s_tri[8 * chunk + j];
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float sgn = det >= 0.0f ? 1.0f : -1.0f;
      const float dn = det * sgn;
      const float un = (tx * px + ty * py + tz * pz) * sgn;
      const float vn = (dx * qx + dy * qy + dz * qz) * sgn;
      const float tn = (e2x * qx + e2y * qy + e2z * qz) * sgn;
      const float eb = kEpsBary * dn;
      const bool ok = dn >= kEpsDet && un >= -eb && vn >= -eb && un + vn <= dn + eb &&
                      tn > t_min * dn && tn < tmax * dn && tn * bdn < btn * dn;
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

}  // namespace

// rays (B, 6, R), tmax (B, R), tri (B, 9, tpad), boxes (B, 6, nc) -> out_t,
// out_prim and, unless null, tested (B, R).  R must be a multiple of 256 and
// tpad == nc * chunk.
extern "C" int ff_intersect_general(const float* rays, const float* tmax, const float* tri,
                                    const float* boxes, float* out_t, int* out_prim,
                                    int* tested, int B, int R, int tpad, int nc, int chunk,
                                    float t_min, int any_hit, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (R % kThreads != 0 || tpad != nc * chunk || chunk <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(R / kThreads, B);
  const size_t smem = sizeof(float) * 9 * chunk;
  intersect_general_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rays, tmax, tri, boxes, out_t, out_prim, tested, R, tpad, nc, chunk, t_min, any_hit);
  return (int)cudaGetLastError();
}
