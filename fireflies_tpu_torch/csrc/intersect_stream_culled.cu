// Shared-origin, tile-culled ray/triangle closest-hit and any-hit for large
// scenes, with the Woop table streamed from device memory, for Hopper
// (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_stream.py::
// intersect_pallas_streamed_culled (Pallas body `_kernel_stream_culled`).
// Camera rays and shadow rays reversed to start at a light share one origin,
// so o' = W (o - v0) is a per-triangle constant (table rows 9-11) and a pair
// costs d' = W d plus a division-free in-triangle test, with the best hit
// carried as a rational (tn, dn = |d'_z|).  Each 2048-ray tile walks the
// 128-face clusters of its front-to-back list (tile_cluster_lists).  Where
// asked, a hit ray reads its winner's plane normal (the W2 row, n / |n|^2)
// and material id (row 12) after the walk, so the path tracer needs no
// attribute gather; a miss writes (0, 0, 1) and material 0.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue, 32 operations a pair with its products fused into adds; the
// table (~0.75 MB a variant at 11.5k faces) and the lists stay in L2, so
// device memory traffic is the directions in and the outputs out.  The body
// is B1's, intersect_shared.cuh: 256 faces of the list (two clusters)
// staged at a time with cp.async behind one barrier, a slab vote per warp
// and cluster, and the pair test's multiply-adds fused (kFused).  The eight
// blocks of a 2048-ray tile read the same list.

#include "intersect_shared.cuh"

// dirs (B, 3, R), tmax (B, R), woop (B, 16, tpad), boxes (B, 6, nc) shifted to
// the shared origin, lists (B, R / 2048, nc), counts (B, R / 2048) -> out_t,
// out_prim and, unless null, out_nx/ny/nz/mat and tested (B, R).  R must be a
// multiple of 2048 and tpad == nc * 128.
extern "C" int ff_intersect_stream_culled(const float* dirs, const float* tmax,
                                          const float* woop, const float* boxes,
                                          const int* lists, const int* counts, float* out_t,
                                          int* out_prim, float* out_nx, float* out_ny,
                                          float* out_nz, int* out_mat, int* tested, int B, int R,
                                          int tpad, int nc, float t_min, int any_hit,
                                          void* stream) {
  return ff_shared::launch_intersect_shared<ff_shared::kStreamRows, true, true>(
      dirs, tmax, woop, boxes, lists, counts, out_t, out_prim, out_nx, out_ny, out_nz, out_mat,
      tested, B, R, tpad, nc, ff_shared::kStreamChunk, t_min, any_hit, stream);
}
