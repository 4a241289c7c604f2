// Shared-origin ray/triangle closest-hit and any-hit over every resident
// cluster, with tile culling off, for Hopper (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_kernel.py::
// intersect_pallas_shared (Pallas body `_kernel_shared`), the route the
// reference takes up to 8192 faces with FF_NO_TILE_CULL=1.  There are no
// per-tile lists: every block walks all clusters of `chunk` faces (64 on the
// path) in one front-to-back order, the stable argsort of each cluster
// centre's squared distance from the origin (cluster_order in
// render/cuda/intersect_kernel.py), so once a warp's rays have near hits
// its slab vote against their running best skips the farther clusters.  The
// visiting order also decides which face wins a t-tie.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue; the per-variant Woop table (~70 KB at 1440 faces) stays in
// L2, so device memory traffic is the directions in and (t, prim) out.  The
// body is intersect_shared.cuh, B1's (staged batches, warp votes), with
// every operation rounded on its own (kFused = false).

#include "intersect_shared.cuh"

// dirs (B, 3, R), tmax (B, R), woop (B, 12, tpad), boxes (B, 6, nc) shifted to
// the shared origin, order (B, nc) -> out_t, out_prim and, unless null,
// tested (B, R).  R must be a multiple of 2048, chunk 16 or 64, and
// tpad == nc * chunk.
extern "C" int ff_intersect_shared(const float* dirs, const float* tmax, const float* woop,
                                   const float* boxes, const int* order, float* out_t,
                                   int* out_prim, int* tested, int B, int R, int tpad, int nc,
                                   int chunk, float t_min, int any_hit, void* stream) {
  return ff_shared::launch_intersect_shared<ff_shared::kRows, false, false>(
      dirs, tmax, woop, boxes, order, nullptr, out_t, out_prim, nullptr, nullptr, nullptr,
      nullptr, tested, B, R, tpad, nc, chunk, t_min, any_hit, stream);
}
