// General-origin, tile-culled ray/triangle closest-hit and any-hit for Hopper
// (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_culled.py::
// intersect_pallas_general_culled (Pallas body `_kernel_general_culled`).
// Bounce rays have spatially local origins within a 2048-ray tile, so each
// tile walks only the 64-face clusters on its list (tile_cluster_lists_general
// in plain tensor ops: the tile's origin and direction boxes against each
// cluster box, sorted front to back from the tile's origins), with the
// rational Moller-Trumbore test of intersect_general.cu.  The dispatcher
// sends it bounce rays of scenes from 4096 to 8192 faces.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue, 48 operations a pair with its products fused into adds; the
// per-variant triangle table and the lists stay in L2, so device memory
// traffic is the rays in and (t, prim) out.  The body is B3's,
// intersect_general.cuh, over the tile's list: four listed clusters staged
// a batch with cp.async, each ray tested only against the clusters its own
// slab test opens (bounce rays are not coherent, so a vote over a warp or a
// block opens clusters for rays that do not need them), the batch's open
// (ray, cluster) entries shared out as tasks of 32 lanes, fused P, det, u,
// v.  The eight blocks of a tile read the same list.

#include "intersect_general.cuh"

namespace {
constexpr int kChunk = 64;  // faces per cluster (the reference dispatcher's _GEN_CULL_CHUNK)
}  // namespace

// rays (B, 6, R), tmax (B, R), tri (B, 9, tpad) 16-byte aligned, boxes
// (B, 6, nc), lists (B, R / 2048, nc), counts (B, R / 2048) -> out_t,
// out_prim and, unless null, tested (B, R).  R must be a multiple of 2048
// and tpad == nc * 64.
extern "C" int ff_intersect_general_culled(const float* rays, const float* tmax, const float* tri,
                                           const float* boxes, const int* lists,
                                           const int* counts, float* out_t, int* out_prim,
                                           int* tested, int B, int R, int tpad, int nc,
                                           float t_min, int any_hit, void* stream) {
  return ff_general::launch_intersect_general<true, kChunk>(rays, tmax, tri, boxes, lists, counts,
                                                            out_t, out_prim, tested, B, R, tpad,
                                                            nc, t_min, any_hit, stream);
}
