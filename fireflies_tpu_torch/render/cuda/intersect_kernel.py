"""The resident kernels without tile lists: the CUDA kernels' wrappers,
their plain PyTorch versions, and the packing helpers.

Counterpart of fireflies_tpu/render/pallas/intersect_kernel.py:
`intersect_pallas` (B3, general origins; `csrc/intersect_general.cu`) and
`intersect_pallas_shared` (B6, a shared origin, every cluster in one
front-to-back order; `csrc/intersect_shared.cu`).  Layouts follow the
reference with a leading variant axis B:

  rays  (B, 6, R/128, 128) f32  origin xyz rows 0-2, direction rows 3-5
  dirs  (B, 3, R/128, 128) f32  directions from a shared origin
  tmax  (B, R/128, 128) f32     tmax < 0 marks a dead ray (retired/padding)
  tri   (B, 9, Tpad) f32        v0, e1, e2 of Morton-ordered faces
  woop  (B, 12, Tpad) f32       Woop rows W0, W1, W2 and o' (shared origin)
  boxes (B, 6, NC) f32          per-cluster AABB (min xyz, max xyz)
  order (B, NC) int32           B6's front-to-back cluster order

R is padded to whole 2048-ray tiles with d = (0, 0, 1), tmax = -1; Tpad to
whole clusters of `chunk` faces with zero (never-hit) triangles.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fireflies_tpu_torch._build import Kernel, check_cuda, ptr, stream_of, tested_ptr

Tensor = torch.Tensor

RAY_TILE = 2048
LANES = 128
SUBLANES = RAY_TILE // LANES
CHUNK = 64  # faces per AABB cluster

_BIG = 3.0e38
_EPS_DET = 1e-9
_EPS_BARY = 1e-6

# The plain versions broadcast over (rays, faces) blocks of this size, which
# bounds their temporaries to a few hundred MB at the main path's shapes.
RAY_BLOCK = 16384
FACE_BLOCK = 256

# Cluster sizes the kernels are built for (a template argument each):
# B3's and B6's (B1's too, `intersect_culled`).
GENERAL_KERNEL_CHUNKS = (32, 64, 128)
SHARED_KERNEL_CHUNKS = (16, 64)

KERNEL_SHARED = Kernel("ff_intersect_shared", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dirs tmax woop boxes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # order out_t out_prim
    ctypes.c_void_p,  # tested or null
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R Tpad NC chunk
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # t_min any_hit stream
])
KERNEL = Kernel("ff_intersect_general", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rays tmax tri boxes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out_t out_prim tested-or-null
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R Tpad NC chunk
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # t_min any_hit stream
])


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def morton_order(centroids) -> np.ndarray:
    """Face ordering along a 3D Morton curve (host-side, rest pose)."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / span * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _cluster_boxes(fmin: Tensor, fmax: Tensor, chunk: int) -> Tensor:
    """(B, F, 3) per-face bounds -> (B, 6, NC) per-cluster AABBs."""
    b, f, _ = fmin.shape
    n_chunks = -(-f // chunk)
    pad = n_chunks * chunk - f
    if pad:
        fmin = torch.cat([fmin, fmin.new_full((b, pad, 3), _BIG)], dim=1)
        fmax = torch.cat([fmax, fmax.new_full((b, pad, 3), -_BIG)], dim=1)
    cmin = fmin.reshape(b, n_chunks, chunk, 3).amin(dim=2)
    cmax = fmax.reshape(b, n_chunks, chunk, 3).amax(dim=2)
    return torch.cat([cmin, cmax], dim=2).transpose(1, 2).contiguous()


def _pad_faces(x: Tensor, chunk: int) -> Tensor:
    """(B, K, F) -> (B, K, Tpad) with zero columns."""
    pad = -x.shape[2] % chunk
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def pack_triangles(vertices: Tensor, faces: Tensor, chunk: int = CHUNK):
    """(B, V, 3) vertices over (F, 3) faces -> (tri (B, 9, Tpad),
    boxes (B, 6, NC))."""
    v0 = vertices[:, faces[:, 0]]
    v1 = vertices[:, faces[:, 1]]
    v2 = vertices[:, faces[:, 2]]
    tri = torch.cat([v0, v1 - v0, v2 - v0], dim=2).transpose(1, 2)
    tri = _pad_faces(tri, chunk).contiguous()
    fmin = torch.minimum(torch.minimum(v0, v1), v2)
    fmax = torch.maximum(torch.maximum(v0, v1), v2)
    return tri, _cluster_boxes(fmin, fmax, chunk)


def _pad_rays(x: Tensor, fill, r: int) -> Tensor:
    n = x.shape[1]
    if r == n:
        return x
    tail = torch.as_tensor(fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail.expand(x.shape[0], r - n, *x.shape[2:])], dim=1)


def _pad_tmax(t_max, b: int, n: int, r: int, device) -> Tensor:
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=device).expand(b, n)
    return _pad_rays(t_max, -1.0, r).reshape(b, r // LANES, LANES).contiguous()


def pack_rays(o: Tensor, d: Tensor, t_max):
    """(B, N, 3) rays -> ((B, 6, R/128, 128) SoA, (B, R/128, 128) tmax, N)."""
    b, n, _ = o.shape
    r = -(-n // RAY_TILE) * RAY_TILE
    o = _pad_rays(o, 0.0, r)
    d = _pad_rays(d, [0.0, 0.0, 1.0], r)
    soa = torch.cat([o.transpose(1, 2), d.transpose(1, 2)], dim=1)
    return (soa.reshape(b, 6, r // LANES, LANES).contiguous(),
            _pad_tmax(t_max, b, n, r, o.device), n)


def pack_triangles_woop(vertices: Tensor, faces: Tensor, origin: Tensor, chunk: int = CHUNK):
    """Woop precompute for shared-origin batches.

    Per triangle, with n = e1 x e2 and det = |n|^2, the rows
    W0 = (e2 x n)/det, W1 = (n x e1)/det, W2 = n/det map a point into the
    triangle's unit frame; o' = W (o - v0) is a per-triangle constant for a
    shared origin o, so a (ray, triangle) pair only needs d' = W d.
    origin: (B, 3).  Returns (woop (B, 12, Tpad) [W0, W1, W2, o'],
    boxes (B, 6, NC) shifted by -origin).
    """
    v0 = vertices[:, faces[:, 0]]
    v1 = vertices[:, faces[:, 1]]
    v2 = vertices[:, faces[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = torch.linalg.cross(e1, e2)
    det = torch.sum(n * n, dim=-1, keepdim=True)
    zero = det < 1e-18
    safe_det = torch.where(zero, 1.0, det)
    w0 = torch.where(zero, 0.0, torch.linalg.cross(e2, n) / safe_det)
    w1 = torch.where(zero, 0.0, torch.linalg.cross(n, e1) / safe_det)
    w2 = torch.where(zero, 0.0, n / safe_det)
    rel = origin[:, None, :] - v0
    op = torch.stack(
        [torch.sum(w0 * rel, -1), torch.sum(w1 * rel, -1), torch.sum(w2 * rel, -1)], dim=-1)
    woop = torch.cat([w0, w1, w2, op], dim=2).transpose(1, 2)
    woop = _pad_faces(woop, chunk).contiguous()
    shift = origin[:, None, :]
    fmin = torch.minimum(torch.minimum(v0, v1), v2) - shift
    fmax = torch.maximum(torch.maximum(v0, v1), v2) - shift
    return woop, _cluster_boxes(fmin, fmax, chunk)


def pack_dirs(d: Tensor, t_max, ray_tile: int = RAY_TILE):
    """(B, N, 3) directions -> ((B, 3, R/128, 128) SoA, (B, R/128, 128) tmax, N)."""
    b, n, _ = d.shape
    r = -(-n // ray_tile) * ray_tile
    d = _pad_rays(d, [0.0, 0.0, 1.0], r)
    return (d.transpose(1, 2).reshape(b, 3, r // LANES, LANES).contiguous(),
            _pad_tmax(t_max, b, n, r, d.device), n)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _carry_min(t: Tensor, base: int, best_t: Tensor, best_p: Tensor):
    """Fold a (rays, faces) block of candidate t (BIG = none) into the
    running closest hit."""
    cmin, carg = t.min(dim=1)
    better = cmin < best_t
    return torch.where(better, cmin, best_t), torch.where(better, carg.to(torch.int32) + base, best_p)


def live_ray_blocks(tmax: Tensor):
    """(variant, ray indices) blocks of at most RAY_BLOCK live rays
    (tmax >= 0) of a (B, R) tmax: the plain versions test only these, since
    a dead ray never hits."""
    for bi in range(tmax.shape[0]):
        live = torch.nonzero(tmax[bi] >= 0.0).squeeze(1)
        for s0 in range(0, live.numel(), RAY_BLOCK):
            yield bi, live[s0:s0 + RAY_BLOCK]


def mt_hits_plain(rays_soa: Tensor, tmax_tiles: Tensor, tri: Tensor, t_min: float,
                  listed: Tensor | None = None, chunk: int = CHUNK):
    """The rational Möller-Trumbore test of the general kernels as a
    blocked broadcast over (rays, faces), closest hit by argmin.  With
    `listed` ((B, T, NC) bool, see `intersect_culled.listed_mask`) a ray
    tests only the clusters of `chunk` faces on its 2048-ray tile's list.
    Rounds as B3's and B5's kernels (`csrc/intersect_general.cuh`): the
    components of P = d x e2 as fma(a, b, -(c d)) and the dots det, u and v
    as fma(z, z', fma(y, y', x x')) (`fma32`), every other operation on its
    own.  Returns (t, prim), each (B, R); prim = -1 on a miss."""
    def cross(ay, az, by, bz):  # ay bz - az by, one rounding of the difference
        return fma32(ay, bz, -(az * by))

    def dot(ax, ay, az, bx, by, bz):
        return fma32(az, bz, fma32(ay, by, ax * bx))

    b = rays_soa.shape[0]
    r = tmax_tiles[0].numel()
    rays = rays_soa.reshape(b, 6, r)
    tmax = tmax_tiles.reshape(b, r)
    out_t = torch.zeros(b, r, dtype=torch.float32, device=rays.device)
    out_p = torch.full((b, r), -1, dtype=torch.int32, device=rays.device)
    n_face = tri.shape[2]
    face_cluster = torch.arange(n_face, device=rays.device) // chunk
    for bi, idx in live_ray_blocks(tmax):
        ox, oy, oz, dx, dy, dz = (rays[bi, k, idx, None] for k in range(6))
        tm = tmax[bi, idx, None]
        tile = idx // RAY_TILE
        best_t = torch.full_like(tm[:, 0], _BIG)
        best_p = torch.full(best_t.shape, -1, dtype=torch.int32, device=best_t.device)
        for f0 in range(0, n_face, FACE_BLOCK):
            on_list = None
            if listed is not None:
                on_list = listed[bi][tile[:, None], face_cluster[None, f0:f0 + FACE_BLOCK]]
                if not bool(on_list.any()):
                    continue  # no ray of the block lists these faces
            (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) = (
                tri[bi, k, None, f0:f0 + FACE_BLOCK] for k in range(9))
            px = cross(dy, dz, e2y, e2z)
            py = cross(dz, dx, e2z, e2x)
            pz = cross(dx, dy, e2x, e2y)
            det = dot(e1x, e1y, e1z, px, py, pz)
            tx = ox - v0x
            ty = oy - v0y
            tz = oz - v0z
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            sgn = torch.where(det >= 0.0, 1.0, -1.0)
            dn = det * sgn
            un = dot(tx, ty, tz, px, py, pz) * sgn
            vn = dot(dx, dy, dz, qx, qy, qz) * sgn
            tn = (e2x * qx + e2y * qy + e2z * qz) * sgn
            eb = _EPS_BARY * dn
            ok = ((dn >= _EPS_DET) & (un >= -eb) & (vn >= -eb) & (un + vn <= dn + eb)
                  & (tn > t_min * dn) & (tn < tm * dn))
            if on_list is not None:
                ok &= on_list
            t = torch.where(ok, tn / torch.where(ok, dn, 1.0), _BIG)
            best_t, best_p = _carry_min(t, f0, best_t, best_p)
        out_t[bi, idx] = torch.where(best_p >= 0, best_t, 0.0)
        out_p[bi, idx] = best_p
    return out_t, out_p


def fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """a * b + c of float32 tensors (broadcast) rounded once to float32, as
    the card's fused multiply-add (`__fmaf_rn`) rounds it.  In float64 the
    product is exact and the sum s is one rounding away from the exact sum;
    rounding s to float32 again lands on the wrong side only where s is
    exactly a float32 midpoint (a midpoint nearer the exact sum than s would
    be a nearer float64).  In float32's normal range a midpoint's float64
    significand ends in a one and 28 zeros; below it, s is tiny (a sum of 0
    is exact).  Only those few elements are rounded to odd first: TwoSum
    gives the sum's rounding error, and an inexact s (its last bit is even
    there) steps to its neighbour on the error's side.  Rounding that to
    float32 is correct, since 53 >= 24 + 2 bits."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    out = s.float()
    suspect = (((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000)
               | ((s.abs() < 2.0**-125) & (s != 0)))
    if bool(suspect.any()):
        at = suspect.nonzero(as_tuple=True)
        p, c, s = p.expand(s.shape)[at], c.expand(s.shape)[at], s[at]
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        inexact = err.abs() > 0  # not where s is infinite (err is NaN)
        out[at] = torch.where(inexact, torch.nextafter(s, err * torch.inf), s).float()
    return out


def woop_hits_plain(rays_soa: Tensor, tmax_tiles: Tensor, woop: Tensor, listed: Tensor | None,
                    t_min: float, chunk: int, fused: bool = False):
    """The division-free Woop test of the shared-origin and streamed
    kernels as a blocked broadcast over (rays, faces), closest hit by
    argmin.  With `listed` ((B, T, NC) bool, see
    `intersect_culled.listed_mask`) a ray tests only the clusters of
    `chunk` faces on its 2048-ray tile's list; without, every face.
    `rays_soa` is (B, 3, R/128, 128) directions from a shared origin, with
    woop rows 9-11 holding o' = W (o - v0), or (B, 6, R/128, 128) origins
    and directions, with rows 9-11 holding W v0 and o'_k = W_k . o -
    (W v0)_k formed per pair.  The general branch rounds as B4's and B7g's
    kernel (`csrc/intersect_stream.cuh`): o'_k, d'_k, u_n and v_n as chains
    of fused multiply-adds (`fma32`) in the kernel's order, every other
    operation on its own.  The shared-origin branch rounds d'_k, u_n and
    v_n so too with `fused` (B1, B2 and B7s, `csrc/intersect_shared.cuh`
    with kFused), else every operation on its own (B6).  Returns (t, prim),
    each (B, R); prim = -1 on a miss."""
    b, n_comp = rays_soa.shape[:2]
    general = n_comp == 6
    r = tmax_tiles[0].numel()
    rays = rays_soa.reshape(b, n_comp, r)
    tmax = tmax_tiles.reshape(b, r)
    out_t = torch.zeros(b, r, dtype=torch.float32, device=rays.device)
    out_p = torch.full((b, r), -1, dtype=torch.int32, device=rays.device)
    n_face = woop.shape[2]
    face_cluster = torch.arange(n_face, device=rays.device) // chunk
    for bi, idx in live_ray_blocks(tmax):
        ray = [rays[bi, k, idx, None] for k in range(n_comp)]
        dx, dy, dz = ray[-3:]
        tm = tmax[bi, idx, None]
        tile = idx // RAY_TILE
        best_t = torch.full_like(tm[:, 0], _BIG)
        best_p = torch.full(best_t.shape, -1, dtype=torch.int32, device=best_t.device)
        for f0 in range(0, n_face, FACE_BLOCK):
            on_list = None
            if listed is not None:
                on_list = listed[bi][tile[:, None], face_cluster[None, f0:f0 + FACE_BLOCK]]
                if not bool(on_list.any()):
                    continue  # no ray of the block lists these faces
            (w00, w01, w02, w10, w11, w12, w20, w21, w22, opx, opy, opz) = (
                woop[bi, k, None, f0:f0 + FACE_BLOCK] for k in range(12))
            if general:
                ox, oy, oz = ray[:3]
                opx = fma32(w02, oz, fma32(w01, oy, fma32(w00, ox, -opx)))
                opy = fma32(w12, oz, fma32(w11, oy, fma32(w10, ox, -opy)))
                opz = fma32(w22, oz, fma32(w21, oy, fma32(w20, ox, -opz)))
            if general or fused:
                dpx = fma32(w02, dz, fma32(w01, dy, w00 * dx))
                dpy = fma32(w12, dz, fma32(w11, dy, w10 * dx))
                dpz = fma32(w22, dz, fma32(w21, dy, w20 * dx))
            else:
                dpx = w00 * dx + w01 * dy + w02 * dz
                dpy = w10 * dx + w11 * dy + w12 * dz
                dpz = w20 * dx + w21 * dy + w22 * dz
            sgn = torch.where(dpz >= 0.0, 1.0, -1.0)
            dn = dpz * sgn
            tn = -opz * sgn
            if general or fused:
                u_n = fma32(opx, dn, tn * dpx)
                v_n = fma32(opy, dn, tn * dpy)
            else:
                u_n = opx * dn + tn * dpx
                v_n = opy * dn + tn * dpy
            ok = ((dn > 1e-12) & (u_n >= -_EPS_BARY * dn)
                  & (v_n >= -_EPS_BARY * dn) & (u_n + v_n <= (1.0 + _EPS_BARY) * dn)
                  & (tn > t_min * dn) & (tn < tm * dn))
            if on_list is not None:
                ok &= on_list
            t = torch.where(ok, tn / torch.where(ok, dn, 1.0), _BIG)
            best_t, best_p = _carry_min(t, f0, best_t, best_p)
        out_t[bi, idx] = torch.where(best_p >= 0, best_t, 0.0)
        out_p[bi, idx] = best_p
    return out_t, out_p


def intersect_packed_plain(rays_soa: Tensor, tmax_tiles: Tensor, tri: Tensor, boxes: Tensor,
                           t_min: float, any_hit: bool = False, chunk: int = CHUNK):
    """Plain PyTorch version of the general-origin kernel (`mt_hits_plain`
    over every face).  Any-hit returns
    the closest hit too (its `prim >= 0` mask is what any-hit means).
    Returns (t, prim) shaped like `tmax_tiles`; prim = -1 on a miss."""
    del any_hit, boxes, chunk  # the AABB skip is an optimisation, not semantics
    t, prim = mt_hits_plain(rays_soa, tmax_tiles, tri, t_min)
    return t.reshape(tmax_tiles.shape), prim.reshape(tmax_tiles.shape)


def cluster_order(boxes: Tensor) -> Tensor:
    """(B, 6, NC) origin-shifted cluster boxes -> (B, NC) int32: every
    cluster, nearest centre first, by a stable argsort of the centre's
    squared distance from the origin, as `intersect_pallas_shared` orders
    them.  B6 visits the clusters in this order, which decides which face
    wins a t-tie."""
    center = 0.5 * (boxes[:, 0:3] + boxes[:, 3:6])
    dist2 = torch.sum(center * center, dim=1)
    return torch.argsort(dist2, dim=-1, stable=True).to(torch.int32).contiguous()


def intersect_shared_packed_plain(dirs_soa: Tensor, tmax_tiles: Tensor, woop: Tensor,
                                  boxes: Tensor, order: Tensor, t_min: float,
                                  any_hit: bool = False, chunk: int = CHUNK):
    """Plain PyTorch version of the shared-origin kernel over every cluster
    (`woop_hits_plain` without lists).  Any-hit returns the closest hit
    too.  Returns (t, prim) shaped like `tmax_tiles`; prim = -1 on a
    miss."""
    del boxes, order, any_hit  # the AABB skip and the visiting order are optimisations
    t, prim = woop_hits_plain(dirs_soa, tmax_tiles, woop, None, t_min, chunk)
    return t.reshape(tmax_tiles.shape), prim.reshape(tmax_tiles.shape)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def intersect_packed(rays_soa: Tensor, tmax_tiles: Tensor, tri: Tensor, boxes: Tensor,
                     t_min: float, any_hit: bool = False, chunk: int = CHUNK,
                     tested: Tensor | None = None):
    """General-origin closest/any-hit over packed inputs.  CPU tensors take
    the plain version; CUDA tensors launch `csrc/intersect_general.cu`
    (256-ray blocks, grid (R/256, B); `chunk` one of
    GENERAL_KERNEL_CHUNKS) or raise.  `tested` (see `_build.tested_ptr`)
    receives the kernel's per-ray count of tested clusters."""
    if rays_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return intersect_packed_plain(rays_soa, tmax_tiles, tri, boxes, t_min, any_hit, chunk)
    dev = rays_soa.device
    b, _, rows, _ = rays_soa.shape
    r = rows * LANES
    n_face, nc = tri.shape[2], boxes.shape[2]
    if r % RAY_TILE or n_face != nc * chunk or chunk not in GENERAL_KERNEL_CHUNKS:
        raise ValueError(f"bad packing: R={r}, Tpad={n_face}, NC={nc}, chunk={chunk}")
    check_cuda("rays_soa", rays_soa, torch.float32, (b, 6, rows, LANES), dev)
    check_cuda("tmax_tiles", tmax_tiles, torch.float32, (b, rows, LANES), dev)
    check_cuda("tri", tri, torch.float32, (b, 9, n_face), dev)
    check_cuda("boxes", boxes, torch.float32, (b, 6, nc), dev)
    KERNEL.record(rays_soa=rays_soa, tmax_tiles=tmax_tiles, tri=tri, boxes=boxes, t_min=t_min,
                  any_hit=any_hit, chunk=chunk)
    out_t = torch.empty(b, rows, LANES, dtype=torch.float32, device=dev)
    out_p = torch.empty(b, rows, LANES, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(ptr(rays_soa), ptr(tmax_tiles), ptr(tri), ptr(boxes), ptr(out_t),
                      ptr(out_p), tested_ptr(tested, tmax_tiles.shape, dev), b, r, n_face, nc,
                      chunk, float(t_min), int(any_hit), stream_of(dev))
    return out_t, out_p


def intersect_cuda(o: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                   t_min: float = 1e-4, t_max=1e30, any_hit: bool = False,
                   chunk: int = CHUNK):
    """Closest-hit (or any-hit) query for per-ray origins; counterpart of
    `intersect_pallas`.  o, d: (B, N, 3); vertices (B, V, 3).  Returns
    (t (B, N), prim (B, N) int32).  Traversal is detached by construction."""
    tri, boxes = pack_triangles(vertices.detach(), faces, chunk=chunk)
    rays_soa, tmax_tiles, n = pack_rays(o.detach(), d.detach(),
                                        torch.as_tensor(t_max).detach())
    t, prim = intersect_packed(rays_soa, tmax_tiles, tri, boxes, t_min, any_hit, chunk)
    b = o.shape[0]
    return t.reshape(b, -1)[:, :n], prim.reshape(b, -1)[:, :n]


def intersect_shared_packed(dirs_soa: Tensor, tmax_tiles: Tensor, woop: Tensor, boxes: Tensor,
                            t_min: float, any_hit: bool = False, chunk: int = CHUNK,
                            order: Tensor | None = None, tested: Tensor | None = None):
    """Shared-origin closest/any-hit over every cluster (B6) on packed
    inputs: takes the front-to-back `cluster_order` unless given, then CPU
    tensors take the plain version and CUDA tensors launch
    `csrc/intersect_shared.cu` (256-ray blocks, grid (R/256, B); `chunk`
    one of SHARED_KERNEL_CHUNKS) or raise.  `tested` (see
    `_build.tested_ptr`) receives the kernel's per-ray count of tested
    clusters."""
    if order is None:
        order = cluster_order(boxes)
    if dirs_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return intersect_shared_packed_plain(dirs_soa, tmax_tiles, woop, boxes, order, t_min,
                                             any_hit, chunk)
    dev = dirs_soa.device
    b, _, rows, _ = dirs_soa.shape
    r = rows * LANES
    n_face, nc = woop.shape[2], boxes.shape[2]
    if r % RAY_TILE or n_face != nc * chunk or chunk not in SHARED_KERNEL_CHUNKS:
        raise ValueError(f"bad packing: R={r}, Tpad={n_face}, NC={nc}, chunk={chunk}")
    check_cuda("dirs_soa", dirs_soa, torch.float32, (b, 3, rows, LANES), dev)
    check_cuda("tmax_tiles", tmax_tiles, torch.float32, (b, rows, LANES), dev)
    check_cuda("woop", woop, torch.float32, (b, 12, n_face), dev)
    check_cuda("boxes", boxes, torch.float32, (b, 6, nc), dev)
    check_cuda("order", order, torch.int32, (b, nc), dev)
    KERNEL_SHARED.record(dirs_soa=dirs_soa, tmax_tiles=tmax_tiles, woop=woop, boxes=boxes,
                         order=order, t_min=t_min, any_hit=any_hit, chunk=chunk)
    out_t = torch.empty(b, rows, LANES, dtype=torch.float32, device=dev)
    out_p = torch.empty(b, rows, LANES, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL_SHARED.launch(ptr(dirs_soa), ptr(tmax_tiles), ptr(woop), ptr(boxes), ptr(order),
                             ptr(out_t), ptr(out_p), tested_ptr(tested, tmax_tiles.shape, dev), b,
                             r, n_face, nc, chunk, float(t_min), int(any_hit), stream_of(dev))
    return out_t, out_p


def intersect_cuda_shared(origin: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                          t_min: float = 1e-4, t_max=1e30, any_hit: bool = False,
                          chunk: int = CHUNK):
    """Shared-origin closest/any-hit over every cluster, front to back;
    counterpart of `intersect_pallas_shared`.  origin (B, 3), d (B, N, 3).
    Returns (t (B, N), prim (B, N) int32)."""
    woop, boxes = pack_triangles_woop(vertices.detach(), faces, origin.detach(), chunk=chunk)
    dirs_soa, tmax_tiles, n = pack_dirs(d.detach(), torch.as_tensor(t_max).detach())
    t, prim = intersect_shared_packed(dirs_soa, tmax_tiles, woop, boxes, t_min, any_hit, chunk)
    b = d.shape[0]
    return t.reshape(b, -1)[:, :n], prim.reshape(b, -1)[:, :n]
