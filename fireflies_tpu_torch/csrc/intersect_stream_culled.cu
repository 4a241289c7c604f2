// Shared-origin, tile-culled ray/triangle closest-hit and any-hit for large
// scenes, with the Woop table streamed from device memory, for Hopper
// (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_stream.py::
// intersect_pallas_streamed_culled (Pallas body `_kernel_stream_culled`).
// Camera rays and shadow rays reversed to start at a light share one origin,
// so o' = W (o - v0) is a per-triangle constant (table rows 9-11) and a pair
// costs d' = W d plus a division-free in-triangle test, with the best hit
// carried as a rational (tn, dn = |d'_z|).  The winner's plane normal (the
// W2 row, n / |n|^2) and material id (row 12) are kept by select, so the path
// tracer needs no attribute gather; a miss writes (0, 0, 1) and material 0.
// The body (cluster lists, cp.async double buffer, block votes, drain) is
// intersect_stream.cuh.
//
// What bounds it on this card: arithmetic, about 40 float operations per
// ray-triangle pair over the clusters each block tests.  A cluster's 13 rows
// (52 bytes a face) are copied once per block and broadcast to the block's
// 256 rays, four faces per 16-byte shared-memory load; the table (~0.75 MB a
// variant at 11.5k faces) stays in L2, so device memory traffic is the
// directions in and the outputs out.

#include "intersect_stream.cuh"

extern "C" int ff_intersect_stream_culled(const float* dirs, const float* tmax,
                                          const float* woop, const float* boxes,
                                          const int* lists, const int* counts, float* out_t,
                                          int* out_prim, float* out_nx, float* out_ny,
                                          float* out_nz, int* out_mat, int* tested, int B, int R,
                                          int tpad, int nc, float t_min, int any_hit,
                                          void* stream) {
  return ff_stream::launch_stream<false, true>(dirs, tmax, woop, boxes, lists, counts, out_t,
                                               out_prim, out_nx, out_ny, out_nz, out_mat, tested,
                                               B, R, tpad, nc, t_min, any_hit, stream);
}
