// Shared-origin ray/triangle closest-hit and any-hit over every streamed
// cluster, for large scenes with tile culling off, for Hopper (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_stream.py::
// intersect_pallas_streamed (Pallas body `_kernel_stream`, shared=True), the
// route the reference takes above 8192 faces with FF_NO_TILE_CULL=1.  As in
// intersect_stream_culled.cu, o' = W (o - v0) is a per-triangle constant
// (table rows 9-11) and a pair costs d' = W d plus a division-free
// in-triangle test, with the best hit carried as a rational.  There are no
// cluster lists: every block walks all 128-face clusters in index order, as
// the reference does (the walk order decides which face wins a t-tie), and
// only its warps' slab votes against their rays' running best skip a
// cluster's arithmetic.  No attributes are emitted, as in the reference;
// the caller gathers them.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue, 32 operations a pair with its products fused into adds,
// which without lists is most of the clusters.  The table (~0.75 MB a
// variant at 11.5k faces) stays in L2; device memory traffic is the
// directions in and (t, prim) out.  The body is B1's, intersect_shared.cuh
// (256 faces staged a batch with cp.async behind one barrier, warp votes,
// fused steps), over the 16-row streamed table without a walk order.

#include "intersect_shared.cuh"

// dirs (B, 3, R), tmax (B, R), woop (B, 16, tpad), boxes (B, 6, nc) shifted to
// the shared origin -> out_t, out_prim and, unless null, tested (B, R).  R
// must be a multiple of 2048 and tpad == nc * 128.
extern "C" int ff_intersect_stream(const float* dirs, const float* tmax, const float* woop,
                                   const float* boxes, float* out_t, int* out_prim, int* tested,
                                   int B, int R, int tpad, int nc, float t_min, int any_hit,
                                   void* stream) {
  return ff_shared::launch_intersect_shared<ff_shared::kStreamRows, false, true>(
      dirs, tmax, woop, boxes, nullptr, nullptr, out_t, out_prim, nullptr, nullptr, nullptr,
      nullptr, tested, B, R, tpad, nc, ff_shared::kStreamChunk, t_min, any_hit, stream);
}
