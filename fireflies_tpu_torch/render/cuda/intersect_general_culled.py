"""Tile-culled general-origin intersection: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of fireflies_tpu/render/pallas/intersect_culled.py
(`intersect_pallas_general_culled`, B5); the kernel is
`csrc/intersect_general_culled.cu`, on B3's body
(`csrc/intersect_general.cuh`) with lists.  Bounce rays have spatially
local origins per 2048-ray tile, so each tile walks only the clusters of
its `tile_cluster_lists_general` list, front to back from the tile's
origins, with the rational Möller-Trumbore test of the general kernel,
fused steps and all (`mt_hits_plain`).  The dispatcher uses it for
mid-sized scenes (64-face clusters); it emits no hit attributes.

Layouts as in `intersect_kernel`, plus lists (B, T, NC) int32 and counts
(B, T, 1) int32.
"""

from __future__ import annotations

import ctypes

import torch

from fireflies_tpu_torch._build import Kernel, check_cuda, ptr, stream_of, tested_ptr
from fireflies_tpu_torch.render.cuda.intersect_culled import (
    listed_mask,
    tile_cluster_lists_general,
)
from fireflies_tpu_torch.render.cuda.intersect_kernel import (
    LANES,
    RAY_TILE,
    mt_hits_plain,
    pack_rays,
    pack_triangles,
)

Tensor = torch.Tensor

CHUNK = 64  # faces per cluster (the reference dispatcher's _GEN_CULL_CHUNK), kChunk in the .cu

KERNEL = Kernel("ff_intersect_general_culled", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rays tmax tri boxes
    ctypes.c_void_p, ctypes.c_void_p,  # lists counts
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out_t out_prim tested-or-null
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R Tpad NC
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # t_min any_hit stream
])


def intersect_general_culled_packed_plain(rays_soa: Tensor, tmax_tiles: Tensor, tri: Tensor,
                                          boxes: Tensor, lists: Tensor, counts: Tensor,
                                          t_min: float, any_hit: bool = False):
    """Plain PyTorch version: `mt_hits_plain` restricted to the tile lists;
    any-hit returns the closest hit too.  Returns (t, prim) shaped like
    `tmax_tiles`; prim = -1 on a miss."""
    del any_hit, boxes  # the AABB skip is an optimisation, not semantics
    t, prim = mt_hits_plain(rays_soa, tmax_tiles, tri, t_min, listed_mask(lists, counts), CHUNK)
    return t.reshape(tmax_tiles.shape), prim.reshape(tmax_tiles.shape)


def intersect_general_culled_packed(rays_soa: Tensor, tmax_tiles: Tensor, tri: Tensor,
                                    boxes: Tensor, t_min: float, any_hit: bool = False,
                                    lists: Tensor | None = None, counts: Tensor | None = None,
                                    tested: Tensor | None = None):
    """General-origin tile-culled closest/any-hit over packed inputs:
    builds the tile lists unless given, then CPU tensors take the plain
    version and CUDA tensors launch `csrc/intersect_general_culled.cu`
    (256-ray blocks, each on its 2048-ray tile's list, grid (R/256, B)) or
    raise.  `tested` (see
    `_build.tested_ptr`) receives the kernel's per-ray count of tested
    clusters."""
    if lists is None or counts is None:
        lists, counts = tile_cluster_lists_general(rays_soa, boxes, t_min=t_min,
                                                   tmax_tiles=tmax_tiles)
    if rays_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return intersect_general_culled_packed_plain(rays_soa, tmax_tiles, tri, boxes, lists,
                                                     counts, t_min, any_hit)
    dev = rays_soa.device
    b, _, rows, _ = rays_soa.shape
    r = rows * LANES
    n_face, nc = tri.shape[2], boxes.shape[2]
    if r % RAY_TILE or n_face != nc * CHUNK:
        raise ValueError(f"bad packing: R={r}, Tpad={n_face}, NC={nc}, chunk={CHUNK}")
    n_tiles = r // RAY_TILE
    check_cuda("rays_soa", rays_soa, torch.float32, (b, 6, rows, LANES), dev)
    check_cuda("tmax_tiles", tmax_tiles, torch.float32, (b, rows, LANES), dev)
    check_cuda("tri", tri, torch.float32, (b, 9, n_face), dev)
    check_cuda("boxes", boxes, torch.float32, (b, 6, nc), dev)
    check_cuda("lists", lists, torch.int32, (b, n_tiles, nc), dev)
    check_cuda("counts", counts, torch.int32, (b, n_tiles, 1), dev)
    KERNEL.record(rays_soa=rays_soa, tmax_tiles=tmax_tiles, tri=tri, boxes=boxes, lists=lists,
                  counts=counts, t_min=t_min, any_hit=any_hit)
    out_t = torch.empty(b, rows, LANES, dtype=torch.float32, device=dev)
    out_p = torch.empty(b, rows, LANES, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(ptr(rays_soa), ptr(tmax_tiles), ptr(tri), ptr(boxes), ptr(lists),
                      ptr(counts), ptr(out_t), ptr(out_p),
                      tested_ptr(tested, tmax_tiles.shape, dev), b, r, n_face, nc, float(t_min),
                      int(any_hit), stream_of(dev))
    return out_t, out_p


def intersect_cuda_general_culled(o: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                                  t_min: float = 1e-4, t_max=1e30, any_hit: bool = False):
    """Tile-culled general closest/any-hit; counterpart of
    `intersect_pallas_general_culled`.  o, d (B, N, 3) in tile-major order
    (culling bites only then).  Returns (t (B, N), prim (B, N) int32)."""
    tri, boxes = pack_triangles(vertices.detach(), faces, chunk=CHUNK)
    rays_soa, tmax_tiles, n = pack_rays(o.detach(), d.detach(), torch.as_tensor(t_max).detach())
    t, prim = intersect_general_culled_packed(rays_soa, tmax_tiles, tri, boxes, t_min, any_hit)
    b = o.shape[0]
    return t.reshape(b, -1)[:, :n], prim.reshape(b, -1)[:, :n]
