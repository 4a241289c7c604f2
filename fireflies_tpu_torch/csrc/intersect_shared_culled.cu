// Shared-origin, tile-culled ray/triangle closest-hit and any-hit for Hopper
// (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_culled.py::
// intersect_pallas_shared_culled (Pallas body `_kernel_shared_culled`).
// Camera rays and shadow rays reversed to start at a light share one origin,
// so a pair costs d' = W d plus a division-free Woop test.  Each 2048-ray
// tile walks only the clusters on its front-to-back list (built by
// tile_cluster_lists in plain tensor ops: 16 faces a cluster on the path, up
// to 512 clusters at 8192 faces), with a slab test per cluster that skips
// clusters farther than its rays' current best hits.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue, 32 operations a pair with its products fused into adds; the
// per-variant Woop table (~70 KB at 1440 faces) and the lists stay in L2, so
// device memory traffic is the directions in and (t, prim) out.  The body,
// intersect_shared.cuh with kFused = true, stages 256 faces of the list at
// a time with cp.async behind one barrier, lets each warp vote on each
// staged cluster, and fuses the pair test's multiply-adds.  The eight blocks
// of a 2048-ray tile read the same list.

#include "intersect_shared.cuh"

// dirs (B, 3, R), tmax (B, R), woop (B, 12, tpad), boxes (B, 6, nc) shifted to
// the shared origin, lists (B, R / 2048, nc), counts (B, R / 2048) -> out_t,
// out_prim and, unless null, tested (B, R).  R must be a multiple of 2048,
// chunk 16 or 64, and tpad == nc * chunk.
extern "C" int ff_intersect_shared_culled(const float* dirs, const float* tmax,
                                          const float* woop, const float* boxes,
                                          const int* lists, const int* counts, float* out_t,
                                          int* out_prim, int* tested, int B, int R, int tpad,
                                          int nc, int chunk, float t_min, int any_hit,
                                          void* stream) {
  return ff_shared::launch_intersect_shared<ff_shared::kRows, true, true>(
      dirs, tmax, woop, boxes, lists, counts, out_t, out_prim, nullptr, nullptr, nullptr, nullptr,
      tested, B, R, tpad, nc, chunk, t_min, any_hit, stream);
}
