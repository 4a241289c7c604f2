"""Woop intersection for large scenes, with the triangle table streamed
from device memory: the CUDA kernels' wrappers, their plain PyTorch
versions and the packing.

Counterpart of fireflies_tpu/render/pallas/intersect_stream.py.  With tile
culling (`intersect_pallas_streamed_culled`, B2, and
`intersect_pallas_streamed_general_culled`, B4; `csrc/intersect_stream_culled.cu`
and `csrc/intersect_stream_general_culled.cu`) each 2048-ray tile walks its
front-to-back cluster list (`intersect_culled.tile_cluster_lists` for a
shared origin, `tile_cluster_lists_general` for per-ray origins); without
(`intersect_pallas_streamed`, B7s, and `intersect_pallas_streamed_general`,
B7g; `csrc/intersect_stream.cu` and `csrc/intersect_stream_general.cu`)
every tile walks all clusters in index order.  The shared-origin kernels
(B2, B7s) run on B1's body (`csrc/intersect_shared.cuh`: two 128-face
clusters staged a batch, a slab vote per warp, fused steps); the general
ones (B4, B7g) on `csrc/intersect_stream.cuh` (one cluster staged at a
time, each ray tested against the clusters its own slab test opens).
With `emit_attrs` the culled kernels also return the winning face's
unnormalized plane normal (Woop row W2 = n / |n|^2) and material id (woop
row 12), read after the walk, so the path tracer needs no attribute
gather; a miss gets (0, 0, 1) and material 0.  The unculled kernels emit
no attributes, as in the reference.

Layouts, with a leading variant axis B:
  dirs   (B, 3, R/128, 128) f32 (shared origin) or rays (B, 6, R/128, 128)
  tmax   (B, R/128, 128) f32, tmax < 0 = dead
  woop16 (B, 16, Tpad) f32, Tpad a multiple of 128: rows 0-8 W, rows 9-11 o'
         (shared origin) or W v0 (general), row 12 the material id, 13-15 zero
  boxes  (B, 6, NC) f32, origin-shifted for a shared origin, world otherwise
  lists  (B, T, NC) int32, counts (B, T, 1) int32 (culled kernels only)
"""

from __future__ import annotations

import ctypes

import torch

from fireflies_tpu_torch._build import Kernel, check_cuda, ptr, stream_of, tested_ptr
from fireflies_tpu_torch.render.cuda.intersect_culled import (
    listed_mask,
    tile_cluster_lists,
    tile_cluster_lists_general,
)
from fireflies_tpu_torch.render.cuda.intersect_kernel import (
    LANES,
    RAY_TILE,
    pack_dirs,
    pack_rays,
    pack_triangles_woop,
    woop_hits_plain,
)

Tensor = torch.Tensor

STREAM_CHUNK = 128  # faces per streamed cluster
WOOP_ROWS = 16
MAT_ROW = 12

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rays tmax woop boxes
    ctypes.c_void_p, ctypes.c_void_p,  # lists counts
    ctypes.c_void_p, ctypes.c_void_p,  # out_t out_prim
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out nx ny nz mat or 0
    ctypes.c_void_p,  # tested or 0
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R Tpad NC
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # t_min any_hit stream
]
KERNEL = Kernel("ff_intersect_stream_culled", _ARGS)
KERNEL_GENERAL = Kernel("ff_intersect_stream_general_culled", _ARGS)
_ARGS_UNCULLED = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rays tmax woop boxes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out_t out_prim tested-or-null
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R Tpad NC
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # t_min any_hit stream
]
KERNEL_UNCULLED = Kernel("ff_intersect_stream", _ARGS_UNCULLED)
KERNEL_UNCULLED_GENERAL = Kernel("ff_intersect_stream_general", _ARGS_UNCULLED)


def pack_woop_streamed(vertices: Tensor, faces: Tensor, origin: Tensor | None,
                       face_mat: Tensor | None = None):
    """(woop16 (B, 16, Tpad), boxes (B, 6, NC)) with Tpad % 128 == 0.

    With `origin` (B, 3), rows 9-11 hold o' = W (o - v0) and the boxes are
    shifted by -origin; without, rows 9-11 hold W v0 and the boxes stay in
    world space.  With `face_mat` (F,), row 12 holds each face's material
    id as f32, which rides the same copies the kernels already make."""
    b = vertices.shape[0]
    shared = origin is not None
    if not shared:
        origin = torch.zeros(b, 3, dtype=vertices.dtype, device=vertices.device)
    woop, boxes = pack_triangles_woop(vertices, faces, origin, chunk=STREAM_CHUNK)
    if not shared:
        woop[:, 9:12] = -woop[:, 9:12]  # W (0 - v0) -> W v0
    woop16 = torch.zeros(b, WOOP_ROWS, woop.shape[2], dtype=torch.float32, device=woop.device)
    woop16[:, :12] = woop
    if face_mat is not None:
        woop16[:, MAT_ROW, :face_mat.shape[0]] = face_mat.to(torch.float32)
    return woop16, boxes


def stream_culled_packed_plain(rays_soa: Tensor, tmax_tiles: Tensor, woop16: Tensor,
                               boxes: Tensor, lists: Tensor, counts: Tensor, t_min: float,
                               any_hit: bool = False, emit_attrs: bool = False):
    """Plain PyTorch version of both culled streamed kernels:
    `woop_hits_plain` over the tile lists with the kernels' fused steps
    (shared origin for (B, 3, ...) directions, general for (B, 6, ...)
    rays), then the winner's W2 row and material id.
    Any-hit returns the closest hit too.  Returns (t, prim[, nx, ny, nz,
    mat]) shaped like `tmax_tiles`."""
    del any_hit, boxes  # the AABB skip is an optimisation, not semantics
    t, prim = woop_hits_plain(rays_soa, tmax_tiles, woop16, listed_mask(lists, counts), t_min,
                              STREAM_CHUNK, fused=True)
    outs = [t, prim]
    if emit_attrs:
        idx = prim.clamp(min=0).long()
        hit = prim >= 0
        for row, miss in ((6, 0.0), (7, 0.0), (8, 1.0)):
            outs.append(torch.where(hit, torch.gather(woop16[:, row], 1, idx), miss))
        mat = torch.gather(woop16[:, MAT_ROW], 1, idx).to(torch.int32)
        outs.append(torch.where(hit, mat, 0))
    return tuple(x.reshape(tmax_tiles.shape) for x in outs)


def stream_packed_plain(rays_soa: Tensor, tmax_tiles: Tensor, woop16: Tensor, boxes: Tensor,
                        t_min: float, any_hit: bool = False):
    """Plain PyTorch version of both unculled streamed kernels:
    `woop_hits_plain` over every face with the kernels' fused steps
    (shared origin for (B, 3, ...) directions, general for (B, 6, ...)
    rays).  Any-hit returns the closest
    hit too.  Returns (t, prim) shaped like `tmax_tiles`."""
    del any_hit, boxes  # the AABB skip is an optimisation, not semantics
    t, prim = woop_hits_plain(rays_soa, tmax_tiles, woop16, None, t_min, STREAM_CHUNK,
                              fused=True)
    return t.reshape(tmax_tiles.shape), prim.reshape(tmax_tiles.shape)


def _launch(kernel: Kernel, n_comp: int, rays_soa: Tensor, tmax_tiles: Tensor, woop16: Tensor,
            boxes: Tensor, t_min: float, any_hit: bool, tested: Tensor | None,
            lists: Tensor | None = None, counts: Tensor | None = None,
            emit_attrs: bool = False):
    """Check the packed inputs and launch a streamed kernel: a culled one
    with `lists` and `counts` (and optional attributes), an unculled one
    without."""
    dev = rays_soa.device
    b, _, rows, _ = rays_soa.shape
    r = rows * LANES
    n_face, nc = woop16.shape[2], boxes.shape[2]
    if r % RAY_TILE or n_face != nc * STREAM_CHUNK:
        raise ValueError(f"bad packing: R={r}, Tpad={n_face}, NC={nc}, chunk={STREAM_CHUNK}")
    n_tiles = r // RAY_TILE
    check_cuda("rays_soa", rays_soa, torch.float32, (b, n_comp, rows, LANES), dev)
    check_cuda("tmax_tiles", tmax_tiles, torch.float32, (b, rows, LANES), dev)
    check_cuda("woop16", woop16, torch.float32, (b, WOOP_ROWS, n_face), dev)
    check_cuda("boxes", boxes, torch.float32, (b, 6, nc), dev)
    if woop16.data_ptr() % 16:
        raise ValueError("woop16: the kernel copies 16-byte vectors and needs 16-byte alignment")
    out_t = torch.empty(b, rows, LANES, dtype=torch.float32, device=dev)
    out_p = torch.empty(b, rows, LANES, dtype=torch.int32, device=dev)
    if lists is None:
        kernel.record(rays_soa=rays_soa, tmax_tiles=tmax_tiles, woop16=woop16, boxes=boxes,
                      t_min=t_min, any_hit=any_hit)
        with torch.cuda.device(dev):
            kernel.launch(ptr(rays_soa), ptr(tmax_tiles), ptr(woop16), ptr(boxes), ptr(out_t),
                          ptr(out_p), tested_ptr(tested, tmax_tiles.shape, dev), b, r, n_face, nc,
                          float(t_min), int(any_hit), stream_of(dev))
        return out_t, out_p
    check_cuda("lists", lists, torch.int32, (b, n_tiles, nc), dev)
    check_cuda("counts", counts, torch.int32, (b, n_tiles, 1), dev)
    kernel.record(rays_soa=rays_soa, tmax_tiles=tmax_tiles, woop16=woop16, boxes=boxes,
                  lists=lists, counts=counts, t_min=t_min, any_hit=any_hit,
                  emit_attrs=emit_attrs)
    attrs = []
    if emit_attrs:
        attrs = [torch.empty(b, rows, LANES, dtype=dt, device=dev)
                 for dt in (torch.float32, torch.float32, torch.float32, torch.int32)]
    attr_ptrs = [ptr(a) for a in attrs] if attrs else [None] * 4
    with torch.cuda.device(dev):
        kernel.launch(ptr(rays_soa), ptr(tmax_tiles), ptr(woop16), ptr(boxes), ptr(lists),
                      ptr(counts), ptr(out_t), ptr(out_p), *attr_ptrs,
                      tested_ptr(tested, tmax_tiles.shape, dev), b, r, n_face, nc, float(t_min),
                      int(any_hit), stream_of(dev))
    return (out_t, out_p, *attrs)


def intersect_stream_culled_packed(rays_soa: Tensor, tmax_tiles: Tensor, woop16: Tensor,
                                   boxes: Tensor, t_min: float, any_hit: bool = False,
                                   emit_attrs: bool = False, lists: Tensor | None = None,
                                   counts: Tensor | None = None, tested: Tensor | None = None):
    """Shared-origin streamed closest/any-hit (B2) over packed inputs
    (`rays_soa` holds the (B, 3, R/128, 128) directions): builds the tile
    lists unless given, then CPU tensors take the plain version and CUDA
    tensors launch `csrc/intersect_stream_culled.cu` (256-ray blocks, each
    on its 2048-ray tile's list, grid (R/256, B)) or raise.  Returns (t, prim[, nx, ny, nz, mat]) shaped
    like `tmax_tiles`.  `tested` (see `_build.tested_ptr`) receives the
    kernel's per-ray count of tested clusters."""
    if lists is None or counts is None:
        lists, counts = tile_cluster_lists(rays_soa, boxes, t_min=t_min, tmax_tiles=tmax_tiles)
    if rays_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return stream_culled_packed_plain(rays_soa, tmax_tiles, woop16, boxes, lists, counts,
                                          t_min, any_hit, emit_attrs)
    return _launch(KERNEL, 3, rays_soa, tmax_tiles, woop16, boxes, t_min, any_hit, tested,
                   lists, counts, emit_attrs)


def intersect_stream_general_culled_packed(rays_soa: Tensor, tmax_tiles: Tensor,
                                           woop16: Tensor, boxes: Tensor, t_min: float,
                                           any_hit: bool = False, emit_attrs: bool = False,
                                           lists: Tensor | None = None,
                                           counts: Tensor | None = None,
                                           tested: Tensor | None = None):
    """General-origin streamed closest/any-hit (B4) over packed inputs;
    as `intersect_stream_culled_packed` with `tile_cluster_lists_general`
    and `csrc/intersect_stream_general_culled.cu`."""
    if lists is None or counts is None:
        lists, counts = tile_cluster_lists_general(rays_soa, boxes, t_min=t_min,
                                                   tmax_tiles=tmax_tiles)
    if rays_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return stream_culled_packed_plain(rays_soa, tmax_tiles, woop16, boxes, lists, counts,
                                          t_min, any_hit, emit_attrs)
    return _launch(KERNEL_GENERAL, 6, rays_soa, tmax_tiles, woop16, boxes, t_min, any_hit,
                   tested, lists, counts, emit_attrs)


def intersect_stream_packed(rays_soa: Tensor, tmax_tiles: Tensor, woop16: Tensor, boxes: Tensor,
                            t_min: float, any_hit: bool = False, tested: Tensor | None = None):
    """Shared-origin streamed closest/any-hit over every cluster (B7s) on
    packed inputs (`rays_soa` holds the (B, 3, R/128, 128) directions): CPU
    tensors take the plain version, CUDA tensors launch
    `csrc/intersect_stream.cu` (256-ray blocks, grid (R/256, B)) or
    raise.  Returns (t, prim) shaped like `tmax_tiles`.  `tested` (see
    `_build.tested_ptr`) receives the kernel's per-ray count of tested
    clusters."""
    if rays_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return stream_packed_plain(rays_soa, tmax_tiles, woop16, boxes, t_min, any_hit)
    return _launch(KERNEL_UNCULLED, 3, rays_soa, tmax_tiles, woop16, boxes, t_min, any_hit,
                   tested)


def intersect_stream_general_packed(rays_soa: Tensor, tmax_tiles: Tensor, woop16: Tensor,
                                    boxes: Tensor, t_min: float, any_hit: bool = False,
                                    tested: Tensor | None = None):
    """General-origin streamed closest/any-hit over every cluster (B7g);
    as `intersect_stream_packed` with (B, 6, R/128, 128) rays and
    `csrc/intersect_stream_general.cu`."""
    if rays_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return stream_packed_plain(rays_soa, tmax_tiles, woop16, boxes, t_min, any_hit)
    return _launch(KERNEL_UNCULLED_GENERAL, 6, rays_soa, tmax_tiles, woop16, boxes, t_min,
                   any_hit, tested)


def _unpad(outs, b: int, n: int):
    return tuple(x.reshape(b, -1)[:, :n] for x in outs)


def intersect_cuda_streamed_culled(origin: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                                   t_min: float = 1e-4, t_max=1e30, any_hit: bool = False,
                                   face_mat: Tensor | None = None):
    """Tile-culled shared-origin closest/any-hit for large scenes;
    counterpart of `intersect_pallas_streamed_culled`.  origin (B, 3), d
    (B, N, 3) in tile-major order.  Returns (t, prim), or with `face_mat`
    (t, prim, nx, ny, nz, mat), each (B, N)."""
    woop16, boxes = pack_woop_streamed(vertices.detach(), faces, origin.detach(), face_mat)
    dirs_soa, tmax_tiles, n = pack_dirs(d.detach(), torch.as_tensor(t_max).detach())
    outs = intersect_stream_culled_packed(dirs_soa, tmax_tiles, woop16, boxes, t_min, any_hit,
                                          emit_attrs=face_mat is not None)
    return _unpad(outs, d.shape[0], n)


def intersect_cuda_streamed_general_culled(o: Tensor, d: Tensor, vertices: Tensor,
                                           faces: Tensor, t_min: float = 1e-4, t_max=1e30,
                                           any_hit: bool = False,
                                           face_mat: Tensor | None = None):
    """Tile-culled per-ray-origin closest/any-hit for large scenes;
    counterpart of `intersect_pallas_streamed_general_culled`.  o, d
    (B, N, 3).  Returns as `intersect_cuda_streamed_culled`."""
    woop16, boxes = pack_woop_streamed(vertices.detach(), faces, None, face_mat)
    rays_soa, tmax_tiles, n = pack_rays(o.detach(), d.detach(), torch.as_tensor(t_max).detach())
    outs = intersect_stream_general_culled_packed(rays_soa, tmax_tiles, woop16, boxes, t_min,
                                                  any_hit, emit_attrs=face_mat is not None)
    return _unpad(outs, o.shape[0], n)


def intersect_cuda_streamed(origin: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                            t_min: float = 1e-4, t_max=1e30, any_hit: bool = False):
    """Shared-origin closest/any-hit for large scenes over every cluster;
    counterpart of `intersect_pallas_streamed`.  origin (B, 3), d (B, N, 3).
    Returns (t, prim), each (B, N)."""
    woop16, boxes = pack_woop_streamed(vertices.detach(), faces, origin.detach())
    dirs_soa, tmax_tiles, n = pack_dirs(d.detach(), torch.as_tensor(t_max).detach())
    outs = intersect_stream_packed(dirs_soa, tmax_tiles, woop16, boxes, t_min, any_hit)
    return _unpad(outs, d.shape[0], n)


def intersect_cuda_streamed_general(o: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                                    t_min: float = 1e-4, t_max=1e30, any_hit: bool = False):
    """Per-ray-origin closest/any-hit for large scenes over every cluster;
    counterpart of `intersect_pallas_streamed_general`.  o, d (B, N, 3).
    Returns (t, prim), each (B, N)."""
    woop16, boxes = pack_woop_streamed(vertices.detach(), faces, None)
    rays_soa, tmax_tiles, n = pack_rays(o.detach(), d.detach(), torch.as_tensor(t_max).detach())
    outs = intersect_stream_general_packed(rays_soa, tmax_tiles, woop16, boxes, t_min, any_hit)
    return _unpad(outs, o.shape[0], n)
