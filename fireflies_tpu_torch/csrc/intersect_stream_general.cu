// General-origin ray/triangle closest-hit and any-hit over every streamed
// cluster, for large scenes with tile culling off, for Hopper (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_stream.py::
// intersect_pallas_streamed_general (Pallas body `_kernel_stream`,
// shared=False), the bounce-ray route the reference takes above 8192 faces
// with FF_NO_TILE_CULL=1.  The table's rows 9-11 hold W v0 and each pair
// forms o'_k = W_k . o - (W v0)_k before the division-free Woop test.  Every
// block walks all 128-face clusters in index order (not front to back, so
// the running best prunes less than on B4's lists), double-buffering them
// with cp.async; a ray's own slab test skips a cluster's arithmetic for it.
// No attributes are emitted, as in the reference.  The body is
// intersect_stream.cuh.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue, 41 operations a pair counted with every product that feeds
// an add fused into it; the table stays in L2, and device memory traffic is
// the rays in and (t, prim) out.  It shares B4's kernel,
// stream_general_kernel (explicit FMAs, each ray tested only against the
// clusters its own slab test opens, no attributes in the walk).

#include "intersect_stream.cuh"

// rays (B, 6, R), tmax (B, R), woop (B, 16, tpad), boxes (B, 6, nc) in world
// space -> out_t, out_prim and, unless null, tested (B, R).
extern "C" int ff_intersect_stream_general(const float* rays, const float* tmax,
                                           const float* woop, const float* boxes, float* out_t,
                                           int* out_prim, int* tested, int B, int R, int tpad,
                                           int nc, float t_min, int any_hit, void* stream) {
  return ff_stream::launch_stream<true, false>(rays, tmax, woop, boxes, nullptr, nullptr, out_t,
                                               out_prim, nullptr, nullptr, nullptr, nullptr,
                                               tested, B, R, tpad, nc, t_min, any_hit, stream);
}
