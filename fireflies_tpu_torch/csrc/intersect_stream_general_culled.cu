// General-origin, tile-culled ray/triangle closest-hit and any-hit for large
// scenes, with the Woop table streamed from device memory, for Hopper
// (sm_90a).
//
// Replaces fireflies_tpu/render/pallas/intersect_stream.py::
// intersect_pallas_streamed_general_culled (Pallas body
// `_kernel_stream_general_culled`).  Bounce rays have their own origins, so
// the table's rows 9-11 hold W v0 and each pair forms o'_k = W_k . o -
// (W v0)_k before the same division-free Woop test as the shared-origin
// kernel.  Each 2048-ray tile walks the list of tile_cluster_lists_general
// (the tile's origin and direction boxes against each cluster box, front to
// back from the tile's origins); a tile whose count is 0 (every ray dead)
// issues no copy.  Plane normal and material id are emitted as in
// intersect_stream_culled.cu (miss: (0, 0, 1) and 0).  The body is
// intersect_stream.cuh.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue.  Counted with every product that feeds an add fused into it,
// the pair test is 41 operations (the shared-origin test's 32 plus three
// FMAs a row for o'); the table stays in L2 as there, and device memory
// traffic is the rays in and the outputs out.  stream_general_kernel in
// intersect_stream.cuh is built for that: its fused steps are explicit
// FMAs, a ray is tested only against the clusters its own slab test opens
// (the block's open rays are gathered and its warps share their tasks
// evenly), and no attribute is carried through the walk (the winner's are
// read once after it).

#include "intersect_stream.cuh"

extern "C" int ff_intersect_stream_general_culled(const float* rays, const float* tmax,
                                                  const float* woop, const float* boxes,
                                                  const int* lists, const int* counts,
                                                  float* out_t, int* out_prim, float* out_nx,
                                                  float* out_ny, float* out_nz, int* out_mat,
                                                  int* tested, int B, int R, int tpad, int nc,
                                                  float t_min, int any_hit, void* stream) {
  return ff_stream::launch_stream_general<true>(
      rays, tmax, woop, boxes, lists, counts, out_t, out_prim, out_nx, out_ny, out_nz, out_mat,
      tested, B, R, tpad, nc, t_min, any_hit, stream);
}
