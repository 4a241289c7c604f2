// General-origin ray/triangle closest-hit and any-hit for Hopper (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_kernel.py::intersect_pallas
// (Pallas body `_kernel`): Moller-Trumbore over Morton-ordered clusters of
// `chunk` faces (64 on the path), every cluster in index order, an AABB slab
// test per cluster that skips it where the ray cannot reach it closer than
// its best hit so far, and the best hit carried as a rational (tn, dn =
// |det|) so the pair test needs no division.  Used for bounce rays (per-ray
// origins) up to 4096 faces with tile culling and up to 8192 without.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue, 48 operations a pair with its products fused into adds; the
// table stays in L2, so device memory traffic is the rays in and (t, prim)
// out.  The body is intersect_general.cuh without lists: 256 faces staged a
// batch with cp.async, each ray tested only against the clusters its own
// slab test opens (compacted tasks of ray_tasks.cuh), fused P, det, u, v.

#include "intersect_general.cuh"

// rays (B, 6, R), tmax (B, R), tri (B, 9, tpad) 16-byte aligned, boxes
// (B, 6, nc) -> out_t, out_prim and, unless null, tested (B, R).  R must be
// a multiple of 256, chunk 32, 64 or 128 faces, and tpad == nc * chunk.
extern "C" int ff_intersect_general(const float* rays, const float* tmax, const float* tri,
                                    const float* boxes, float* out_t, int* out_prim,
                                    int* tested, int B, int R, int tpad, int nc, int chunk,
                                    float t_min, int any_hit, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  switch (chunk) {
    case 32:
      return ff_general::launch_intersect_general<false, 32>(
          rays, tmax, tri, boxes, nullptr, nullptr, out_t, out_prim, tested, B, R, tpad, nc,
          t_min, any_hit, stream);
    case 64:
      return ff_general::launch_intersect_general<false, 64>(
          rays, tmax, tri, boxes, nullptr, nullptr, out_t, out_prim, tested, B, R, tpad, nc,
          t_min, any_hit, stream);
    case 128:
      return ff_general::launch_intersect_general<false, 128>(
          rays, tmax, tri, boxes, nullptr, nullptr, out_t, out_prim, tested, B, R, tpad, nc,
          t_min, any_hit, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
