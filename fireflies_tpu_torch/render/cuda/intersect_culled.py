"""Tile-culled shared-origin intersection: the CUDA kernel's wrapper, its
plain PyTorch version, and the per-tile cluster lists.

Counterpart of fireflies_tpu/render/pallas/intersect_culled.py
(`intersect_pallas_shared_culled`); the kernel is
`csrc/intersect_shared_culled.cu`.  Camera rays and shadow rays reversed
to start at a light share one origin, so triangles are pre-mapped by the
Woop transform (`pack_triangles_woop`) and each 2048-ray tile walks only
the clusters its direction box can reach, front to back
(`tile_cluster_lists`, plain tensor ops as in the reference).  The general
(per-ray origin) counterpart of the lists, `tile_cluster_lists_general`,
feeds the culled general kernels (`intersect_general_culled`,
`intersect_stream`).

Layouts, with a leading variant axis B:
  dirs   (B, 3, R/128, 128) f32,  tmax (B, R/128, 128) f32 (tmax < 0 = dead)
  woop   (B, 12, Tpad) f32,       boxes (B, 6, NC) f32, origin-shifted
  lists  (B, T, NC) int32,        counts (B, T, 1) int32
"""

from __future__ import annotations

import ctypes

import torch

from fireflies_tpu_torch._build import Kernel, check_cuda, ptr, stream_of, tested_ptr
from fireflies_tpu_torch.render.cuda.intersect_kernel import (
    LANES,
    RAY_TILE,
    SHARED_KERNEL_CHUNKS,
    pack_dirs,
    pack_triangles_woop,
    woop_hits_plain,
)

Tensor = torch.Tensor

CHUNK = 16  # faces per cluster on the shared-origin route
_INF = 3.0e38

KERNEL = Kernel("ff_intersect_shared_culled", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dirs tmax woop boxes
    ctypes.c_void_p, ctypes.c_void_p,  # lists counts
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out_t out_prim tested-or-null
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R Tpad NC chunk
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # t_min any_hit stream
])


def _safe_div(a: Tensor, b: Tensor) -> Tensor:
    return a / torch.where(b.abs() < 1e-30, torch.where(b < 0, -1e-30, 1e-30), b)


def _interval_slab_hit(dl, dh, bl, bh, t_min: float) -> Tensor:
    """Conservative interval slab test over axis 1 (xyz): does any t > t_min
    with d in [dl, dh] put t*d inside [bl, bh] on all three axes?"""
    shape = torch.broadcast_shapes(dl.shape, bl.shape)
    lo = torch.full(shape, t_min, dtype=torch.float32, device=dl.device)
    hi = torch.full(shape, _INF, dtype=torch.float32, device=dl.device)
    lo = torch.where(dl < 0, torch.maximum(lo, _safe_div(bh, dl)), lo)
    hi = torch.where(dl > 0, torch.minimum(hi, _safe_div(bh, dl)), hi)
    empty = (dl == 0) & (bh < 0)
    lo = torch.where(dh > 0, torch.maximum(lo, _safe_div(bl, dh)), lo)
    hi = torch.where(dh < 0, torch.minimum(hi, _safe_div(bl, dh)), hi)
    empty = empty | ((dh == 0) & (bl > 0))
    return (lo.amax(dim=1) <= hi.amin(dim=1)) & ~empty.any(dim=1)


def tile_cluster_lists(dirs_soa: Tensor, boxes: Tensor, t_min: float = 0.0,
                       tmax_tiles: Tensor | None = None):
    """Conservative per-tile cluster culling (shared origin at 0).

    For tile i of variant b, lists[b, i, :counts[b, i, 0]] are the clusters
    some direction in the tile's direction box may hit, sorted front to
    back by centroid distance.  With `tmax_tiles`, dead rays leave the box
    and all-dead tiles get count 0.  Returns (lists (B, T, NC) int32,
    counts (B, T, 1) int32).
    """
    b = dirs_soa.shape[0]
    t = dirs_soa.shape[2] * LANES // RAY_TILE
    d_tiles = dirs_soa.reshape(b, 3, t, RAY_TILE)
    if tmax_tiles is not None:
        alive = (tmax_tiles >= 0.0).reshape(b, 1, t, RAY_TILE)
        dl = torch.where(alive, d_tiles, _INF).amin(dim=-1)
        dh = torch.where(alive, d_tiles, -_INF).amax(dim=-1)
        galive = alive.any(dim=-1)[:, 0]  # (B, T)
    else:
        dl = d_tiles.amin(dim=-1)
        dh = d_tiles.amax(dim=-1)
        galive = None
    hit = _interval_slab_hit(dl[..., None], dh[..., None], boxes[:, 0:3, None, :],
                             boxes[:, 3:6, None, :], t_min)  # (B, T, NC)
    if galive is not None:
        hit = hit & galive[..., None]
    center = 0.5 * (boxes[:, 0:3] + boxes[:, 3:6])
    dist2 = torch.sum(center * center, dim=1)  # (B, NC)
    sort_key = torch.where(hit, dist2[:, None, :], _INF)
    lists = torch.argsort(sort_key, dim=-1, stable=True).to(torch.int32)
    counts = hit.sum(dim=-1, dtype=torch.int32)[..., None]
    return lists.contiguous(), counts.contiguous()


def tile_cluster_lists_general(rays_soa: Tensor, boxes: Tensor, t_min: float = 0.0,
                               tmax_tiles: Tensor | None = None):
    """Per-tile cluster culling and front-to-back order for general rays.

    rays_soa (B, 6, R/128, 128) packed o/d in tile-major order, boxes
    (B, 6, NC) world-space cluster AABBs.  The interval slab test widens a
    cluster's box by the tile's origin box ([bl - omax, bh - omin]); the
    clusters that pass are sorted by distance from the centre of the
    tile's origin box, so a kernel's best-t clip prunes far clusters once
    near hits land.  With `tmax_tiles`, dead rays (tmax < 0) leave both the
    origin and the direction box, and all-dead tiles get count 0.  The
    reference's sub-tile split (FF_CULL_SUBTILES) is not ported: one box
    per tile, its default.  Returns (lists (B, T, NC) int32, counts
    (B, T, 1) int32).
    """
    b = rays_soa.shape[0]
    t = rays_soa.shape[2] * LANES // RAY_TILE
    r_tiles = rays_soa.reshape(b, 6, t, RAY_TILE)
    if tmax_tiles is not None:
        alive = (tmax_tiles >= 0.0).reshape(b, 1, t, RAY_TILE)
        lo = torch.where(alive, r_tiles, _INF).amin(dim=-1)  # (B, 6, T)
        hi = torch.where(alive, r_tiles, -_INF).amax(dim=-1)
        galive = alive.any(dim=-1)[:, 0]  # (B, T)
    else:
        lo = r_tiles.amin(dim=-1)
        hi = r_tiles.amax(dim=-1)
        galive = None
    ol, dl, oh, dh = lo[:, :3], lo[:, 3:], hi[:, :3], hi[:, 3:]
    bl = boxes[:, 0:3, None, :] - oh[..., None]  # (B, 3, T, NC), widened
    bh = boxes[:, 3:6, None, :] - ol[..., None]
    hit = _interval_slab_hit(dl[..., None], dh[..., None], bl, bh, t_min)  # (B, T, NC)
    if galive is not None:
        hit = hit & galive[..., None]
    center = 0.5 * (boxes[:, 0:3] + boxes[:, 3:6])  # (B, 3, NC)
    oc = 0.5 * (ol + oh)  # (B, 3, T); 0 for an all-dead tile
    diff = center[:, :, None, :] - oc[..., None]  # (B, 3, T, NC)
    dist2 = torch.sum(diff * diff, dim=1)  # (B, T, NC)
    sort_key = torch.where(hit, dist2, _INF)
    lists = torch.argsort(sort_key, dim=-1, stable=True).to(torch.int32)
    counts = hit.sum(dim=-1, dtype=torch.int32)[..., None]
    return lists.contiguous(), counts.contiguous()


def listed_mask(lists: Tensor, counts: Tensor) -> Tensor:
    """(B, T, NC) bool: cluster c is on tile t's list."""
    nc = lists.shape[-1]
    pos = torch.arange(nc, device=lists.device)
    mask = torch.zeros(lists.shape, dtype=torch.bool, device=lists.device)
    return mask.scatter_(-1, lists.long(), pos < counts)


def intersect_culled_packed_plain(dirs_soa: Tensor, tmax_tiles: Tensor, woop: Tensor,
                                  boxes: Tensor, lists: Tensor, counts: Tensor,
                                  t_min: float, any_hit: bool = False, chunk: int = CHUNK):
    """Plain PyTorch version of the shared-origin kernel (`woop_hits_plain`
    over the tile lists, rounded as the kernel's fused steps); any-hit
    returns the closest hit too.  Returns (t, prim) shaped like
    `tmax_tiles`; prim = -1 on a miss."""
    del any_hit, boxes  # the AABB skip is an optimisation, not semantics
    t, prim = woop_hits_plain(dirs_soa, tmax_tiles, woop, listed_mask(lists, counts), t_min,
                              chunk, fused=True)
    return t.reshape(tmax_tiles.shape), prim.reshape(tmax_tiles.shape)


def intersect_culled_packed(dirs_soa: Tensor, tmax_tiles: Tensor, woop: Tensor, boxes: Tensor,
                            t_min: float, any_hit: bool = False, chunk: int = CHUNK,
                            lists: Tensor | None = None, counts: Tensor | None = None,
                            tested: Tensor | None = None):
    """Shared-origin closest/any-hit over packed inputs: builds the tile
    lists unless given, then CPU tensors take the plain version and CUDA
    tensors launch `csrc/intersect_shared_culled.cu` (256-ray blocks, each
    on its 2048-ray tile's list, grid (R/256, B); `chunk` one of
    SHARED_KERNEL_CHUNKS) or raise.
    `tested` (see `_build.tested_ptr`) receives the kernel's per-ray count
    of tested clusters."""
    if lists is None or counts is None:
        lists, counts = tile_cluster_lists(dirs_soa, boxes, t_min=t_min, tmax_tiles=tmax_tiles)
    if dirs_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return intersect_culled_packed_plain(dirs_soa, tmax_tiles, woop, boxes, lists, counts,
                                             t_min, any_hit, chunk)
    dev = dirs_soa.device
    b, _, rows, _ = dirs_soa.shape
    r = rows * LANES
    n_face, nc = woop.shape[2], boxes.shape[2]
    if r % RAY_TILE or n_face != nc * chunk or chunk not in SHARED_KERNEL_CHUNKS:
        raise ValueError(f"bad packing: R={r}, Tpad={n_face}, NC={nc}, chunk={chunk}")
    n_tiles = r // RAY_TILE
    check_cuda("dirs_soa", dirs_soa, torch.float32, (b, 3, rows, LANES), dev)
    check_cuda("tmax_tiles", tmax_tiles, torch.float32, (b, rows, LANES), dev)
    check_cuda("woop", woop, torch.float32, (b, 12, n_face), dev)
    check_cuda("boxes", boxes, torch.float32, (b, 6, nc), dev)
    check_cuda("lists", lists, torch.int32, (b, n_tiles, nc), dev)
    check_cuda("counts", counts, torch.int32, (b, n_tiles, 1), dev)
    KERNEL.record(dirs_soa=dirs_soa, tmax_tiles=tmax_tiles, woop=woop, boxes=boxes, lists=lists,
                  counts=counts, t_min=t_min, any_hit=any_hit, chunk=chunk)
    out_t = torch.empty(b, rows, LANES, dtype=torch.float32, device=dev)
    out_p = torch.empty(b, rows, LANES, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(ptr(dirs_soa), ptr(tmax_tiles), ptr(woop), ptr(boxes), ptr(lists),
                      ptr(counts), ptr(out_t), ptr(out_p),
                      tested_ptr(tested, tmax_tiles.shape, dev), b, r, n_face, nc, chunk,
                      float(t_min), int(any_hit), stream_of(dev))
    return out_t, out_p


def intersect_cuda_shared_culled(origin: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                                 t_min: float = 1e-4, t_max=1e30, any_hit: bool = False,
                                 chunk: int = CHUNK):
    """Tile-culled shared-origin closest/any-hit; counterpart of
    `intersect_pallas_shared_culled`.  origin (B, 3), d (B, N, 3) in
    tile-major order (culling bites only then; correctness does not depend
    on it).  Returns (t (B, N), prim (B, N) int32)."""
    woop, boxes = pack_triangles_woop(vertices.detach(), faces, origin.detach(), chunk=chunk)
    dirs_soa, tmax_tiles, n = pack_dirs(d.detach(), torch.as_tensor(t_max).detach())
    t, prim = intersect_culled_packed(dirs_soa, tmax_tiles, woop, boxes, t_min, any_hit, chunk)
    b = d.shape[0]
    return t.reshape(b, -1)[:, :n], prim.reshape(b, -1)[:, :n]
