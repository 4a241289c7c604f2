"""Ray/triangle intersection front end (port of
fireflies_tpu/render/intersect.py).

`closest_hit` and `occluded_any` dispatch by ray kind and face count to the
kernel wrappers of `render/cuda`, with the reference's thresholds.  With
tile culling (`tile_cull=True`, the default):

  faces                          shared origin      per-ray origins
  < GEN_CULL_MIN_FACES           B1 shared culled   B3 general
  GEN_CULL_MIN_FACES .. RESIDENT_MAX_FACES
                                 B1 shared culled   B5 general culled (chunk 64)
  > RESIDENT_MAX_FACES           B2 streamed culled B4 streamed general culled

With `tile_cull=False`, the port's counterpart of the reference's
FF_NO_TILE_CULL=1, no kernel walks per-tile lists:

  faces                          shared origin      per-ray origins
  <= RESIDENT_MAX_FACES          B6 shared          B3 general
  > RESIDENT_MAX_FACES           B7s streamed       B7g streamed general

B6 walks every 64-face cluster in one front-to-back order, B7s and B7g
every 128-face cluster in index order.  Rays sharing one origin per variant
(`shared_origin` given) are camera rays and shadow rays reversed to start
at a light.  Above RESIDENT_MAX_FACES with tile culling, a closest-hit call
with `emit_attrs` takes the hit's plane normal and material id from the
kernel; every other route gathers them (`_attrs_fallback`).  Each wrapper
runs its plain PyTorch version on CPU tensors and its CUDA kernel on CUDA
tensors.  `intersect_brute` and `occluded` are the independent reference
scans.

Traversal is detached: the returned (t, prim) carry no gradient; the
static-geometry path tracer takes positions from t along the (detached)
ray and normals/material ids from the Hit.  Every other route re-derives
the hit's attributes differentiably from one packed per-face row
(`build_face_table`, `hit_attributes_table`), so gradients reach the
vertices.
"""

from __future__ import annotations

import torch

from fireflies_tpu_torch.render.cuda import (
    intersect_culled,
    intersect_general_culled,
    intersect_kernel,
    intersect_stream,
)
from fireflies_tpu_torch.render.types import Geometry, Hit
from fireflies_tpu_torch.render.vec3 import Vec3, from_array, rsqrt
from fireflies_tpu_torch.render.vec3 import where as v3_where

Tensor = torch.Tensor

# The reference's face-count thresholds (PALLAS_MAX_TRIS and
# _GEN_CULL_MIN_FACES in fireflies_tpu/render/intersect.py): above
# RESIDENT_MAX_FACES every ray cast goes to the streamed kernels; from
# GEN_CULL_MIN_FACES up to it, per-ray-origin rays go to the culled general
# kernel.
RESIDENT_MAX_FACES = 8192
GEN_CULL_MIN_FACES = 4096

_EPS_DET = 1e-9
_EPS_BARY = 1e-6
_BIG = 3.4e38


def _mt_chunk(o: Tensor, d: Tensor, v0: Tensor, e1: Tensor, e2: Tensor):
    """Möller-Trumbore for all (ray, tri) pairs: o, d (N, 3), v0/e1/e2
    (C, 3) -> t, u, v, valid (N, C)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    small = det.abs() < _EPS_DET
    inv_det = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, det))
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ~small & (u >= -_EPS_BARY) & (v >= -_EPS_BARY) & (u + v <= 1.0 + _EPS_BARY)
    return t, u, v, valid


def _per_ray(bound, b: int, n: int, device) -> Tensor:
    return torch.as_tensor(bound, dtype=torch.float32, device=device).expand(b, n)


def _chunks(geometry: Geometry, bi: int, tri_chunk: int):
    v0, e1, e2 = (x[bi] for x in geometry.triangle_corners())
    for c0 in range(0, v0.shape[0], tri_chunk):
        yield c0, v0[c0:c0 + tri_chunk], e1[c0:c0 + tri_chunk], e2[c0:c0 + tri_chunk]


def intersect_brute(o: Tensor, d: Tensor, geometry: Geometry, t_min=1e-4, t_max=1e30,
                    tri_chunk: int = 512) -> Hit:
    """Closest-hit reference scan.  o, d: (B, N, 3) world-space rays (t in
    units of |d|).  Returns Hit with (B, N) fields, prim = -1 on miss."""
    b, n, _ = o.shape
    dev = o.device
    t_min, t_max = _per_ray(t_min, b, n, dev), _per_ray(t_max, b, n, dev)
    best_t = torch.full((b, n), _BIG, device=dev)
    best_p = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    for bi in range(b):
        for c0, v0, e1, e2 in _chunks(geometry, bi, tri_chunk):
            t, _, _, valid = _mt_chunk(o[bi], d[bi], v0, e1, e2)
            valid &= (t > t_min[bi, :, None]) & (t < t_max[bi, :, None])
            cmin, carg = torch.where(valid, t, _BIG).min(dim=1)
            better = cmin < best_t[bi]
            best_p[bi] = torch.where(better, carg.to(torch.int32) + c0, best_p[bi])
            best_t[bi] = torch.minimum(best_t[bi], cmin)
    valid = best_p >= 0
    zeros = torch.zeros((b, n), device=dev)
    return Hit(t=torch.where(valid, best_t, 0.0), prim=best_p, u=zeros, v=zeros, valid=valid)


def occluded(o: Tensor, d: Tensor, geometry: Geometry, t_min=1e-4, t_max=1.0,
             tri_chunk: int = 512) -> Tensor:
    """Any-hit reference scan for shadow rays: (B, N) True where the segment
    (t_min, t_max) along d is blocked."""
    b, n, _ = o.shape
    dev = o.device
    t_min, t_max = _per_ray(t_min, b, n, dev), _per_ray(t_max, b, n, dev)
    blocked = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for bi in range(b):
        for _, v0, e1, e2 in _chunks(geometry, bi, tri_chunk):
            t, _, _, valid = _mt_chunk(o[bi], d[bi], v0, e1, e2)
            hit = valid & (t > t_min[bi, :, None]) & (t < t_max[bi, :, None])
            blocked[bi] |= hit.any(dim=1)
    return blocked


def _attrs_fallback(hit: Hit, geometry: Geometry) -> Hit:
    """Fill Hit.nx/ny/nz/mat from the hit face: its unnormalized plane
    normal e1 x e2 and material id.  Detached by construction."""
    with torch.no_grad():
        v0, e1, e2 = geometry.triangle_corners()
        n = torch.linalg.cross(e1, e2)  # (B, F, 3)
        prim = hit.prim.clamp(min=0).long()
        rows = torch.gather(n, 1, prim[..., None].expand(*prim.shape, 3))
        mat = geometry.face_mat[prim]
    return hit.replace(nx=rows[..., 0], ny=rows[..., 1], nz=rows[..., 2], mat=mat)


def _shared(shared_origin: Tensor, d: Tensor) -> Tensor:
    return shared_origin.reshape(d.shape[0], 3)


def _check_backend(backend: str) -> None:
    """Only "auto" (the kernel wrappers, which pick kernel or plain version
    by device) exists here; `intersect_brute` and `occluded` are called
    directly."""
    if backend != "auto":
        raise ValueError(f"backend={backend!r}: only 'auto' is supported")


def _general(o: Tensor, d: Tensor, geometry: Geometry, t_min: float, t_max, any_hit: bool,
             chunk: int, tile_cull: bool):
    """Per-ray-origin (t, prim) on the resident kernels: with tile culling
    B5 from GEN_CULL_MIN_FACES faces, else B3."""
    if tile_cull and geometry.faces.shape[0] >= GEN_CULL_MIN_FACES:
        return intersect_general_culled.intersect_cuda_general_culled(
            o, d, geometry.vertices, geometry.faces, t_min=t_min, t_max=t_max, any_hit=any_hit)
    return intersect_kernel.intersect_cuda(o, d, geometry.vertices, geometry.faces, t_min=t_min,
                                           t_max=t_max, any_hit=any_hit, chunk=chunk)


def _shared_resident(shared_origin: Tensor, d: Tensor, geometry: Geometry, t_min: float, t_max,
                     any_hit: bool, chunk: int, tile_cull: bool):
    """Shared-origin (t, prim) on the resident kernels: B1 over the tile
    lists at `chunk` faces a cluster, or without tile culling B6 at the
    reference's 64."""
    origin = _shared(shared_origin, d)
    if not tile_cull:
        return intersect_kernel.intersect_cuda_shared(
            origin, d, geometry.vertices, geometry.faces, t_min=t_min, t_max=t_max,
            any_hit=any_hit)
    return intersect_culled.intersect_cuda_shared_culled(
        origin, d, geometry.vertices, geometry.faces, t_min=t_min, t_max=t_max, any_hit=any_hit,
        chunk=chunk)


def _streamed(o: Tensor, d: Tensor, geometry: Geometry, t_min: float, t_max, any_hit: bool,
              shared_origin: Tensor | None, face_mat: Tensor | None, tile_cull: bool):
    """(t, prim[, nx, ny, nz, mat]) on the streamed kernels: B2, B4 with
    tile culling (attributes with `face_mat`), else B7s, B7g (never
    attributes)."""
    if not tile_cull:
        if shared_origin is not None:
            return intersect_stream.intersect_cuda_streamed(
                _shared(shared_origin, d), d, geometry.vertices, geometry.faces, t_min=t_min,
                t_max=t_max, any_hit=any_hit)
        return intersect_stream.intersect_cuda_streamed_general(
            o, d, geometry.vertices, geometry.faces, t_min=t_min, t_max=t_max, any_hit=any_hit)
    if shared_origin is not None:
        return intersect_stream.intersect_cuda_streamed_culled(
            _shared(shared_origin, d), d, geometry.vertices, geometry.faces, t_min=t_min,
            t_max=t_max, any_hit=any_hit, face_mat=face_mat)
    return intersect_stream.intersect_cuda_streamed_general_culled(
        o, d, geometry.vertices, geometry.faces, t_min=t_min, t_max=t_max, any_hit=any_hit,
        face_mat=face_mat)


def closest_hit(o: Tensor, d: Tensor, geometry: Geometry, t_min: float = 1e-4, t_max=1e30,
                tri_chunk: int = 512, backend: str = "auto",
                shared_origin: Tensor | None = None, emit_attrs: bool = False,
                shared_chunk: int = intersect_culled.CHUNK,
                general_chunk: int = intersect_kernel.CHUNK, tile_cull: bool = True) -> Hit:
    """Closest-hit dispatcher (see the module docstring for the routes).
    o, d: (B, N, 3); `shared_origin` (B, 3) when every ray of a variant
    starts there.  `backend` must be "auto" (else ValueError); `tri_chunk`
    is kept for signature parity and sizes nothing; `shared_chunk` and
    `general_chunk` size B1's and B3's clusters (B2, B4-B7 have fixed
    ones).  `tile_cull=False` takes the routes without tile lists.  With
    emit_attrs the Hit carries nx/ny/nz/mat."""
    del tri_chunk
    _check_backend(backend)
    if geometry.faces.shape[0] > RESIDENT_MAX_FACES:
        face_mat = geometry.face_mat if emit_attrs and tile_cull else None
        t, prim, *attrs = _streamed(o, d, geometry, t_min, t_max, False, shared_origin, face_mat,
                                    tile_cull)
        zeros = torch.zeros_like(t)
        hit = Hit(t=t, prim=prim, u=zeros, v=zeros, valid=prim >= 0)
        if attrs:
            nx, ny, nz, mat = attrs
            return hit.replace(nx=nx, ny=ny, nz=nz, mat=mat)
        return _attrs_fallback(hit, geometry) if emit_attrs else hit
    if shared_origin is not None:
        t, prim = _shared_resident(shared_origin, d, geometry, t_min, t_max, False, shared_chunk,
                                   tile_cull)
    else:
        t, prim = _general(o, d, geometry, t_min, t_max, False, general_chunk, tile_cull)
    zeros = torch.zeros_like(t)
    hit = Hit(t=t, prim=prim, u=zeros, v=zeros, valid=prim >= 0)
    return _attrs_fallback(hit, geometry) if emit_attrs else hit


def occluded_any(o: Tensor, d: Tensor, geometry: Geometry, t_min: float = 1e-4, t_max=1.0,
                 tri_chunk: int = 512, backend: str = "auto",
                 shared_origin: Tensor | None = None,
                 shared_chunk: int = intersect_culled.CHUNK,
                 general_chunk: int = intersect_kernel.CHUNK, tile_cull: bool = True) -> Tensor:
    """Any-hit dispatcher (shadow rays); see closest_hit.  Returns (B, N)
    bool."""
    del tri_chunk
    _check_backend(backend)
    if geometry.faces.shape[0] > RESIDENT_MAX_FACES:
        _, prim = _streamed(o, d, geometry, t_min, t_max, True, shared_origin, None, tile_cull)
    elif shared_origin is not None:
        _, prim = _shared_resident(shared_origin, d, geometry, t_min, t_max, True, shared_chunk,
                                   tile_cull)
    else:
        _, prim = _general(o, d, geometry, t_min, t_max, True, general_chunk, tile_cull)
    return prim >= 0


def hit_attributes(o: Tensor, d: Tensor, hit: Hit, geometry: Geometry) -> dict:
    """The reference's flat form of the hit attributes: o, d (B, N, 3) ->
    position, unit geometric normal (B, N, 3), t, u, v, mat_id, mesh_id
    (B, N); with `geometry.uvs` uv (B, N, 2) and the tangent, with
    `geometry.normals` the smooth_normal.  `hit_attributes_v` in arrays, so
    differentiable with respect to the vertices and the rays; miss lanes
    are pinned (mask them with hit.valid).
    """
    attrs = hit_attributes_v(from_array(o), from_array(d), hit, geometry)
    out = {k: v.to_array() if isinstance(v, Vec3) else v for k, v in attrs.items()
           if k not in ("uv_x", "uv_y")}
    if "uv_x" in attrs:
        out["uv"] = torch.stack([attrs["uv_x"], attrs["uv_y"]], dim=-1)
    return out


def hit_attributes_v(o: Vec3, d: Vec3, hit: Hit, geometry: Geometry) -> dict:
    """The reference's component form of the hit attributes: o, d Vec3 of
    (B, N) components -> position, normal (and tangent, smooth_normal) as
    Vec3, the rest (B, N); `hit_attributes_table` over the geometry's face
    table."""
    return hit_attributes_table(o, d, hit, build_face_table(geometry),
                                has_uvs=geometry.uvs is not None,
                                has_normals=geometry.normals is not None)


def build_face_table(geometry: Geometry) -> Tensor:
    """Every per-face shading quantity packed into one row, (B, F, D), so
    that a path vertex reads its hits' attributes with one row gather.

    Layout (D = 17): p0 (3), e1 (3), e2 (3), uv0 (2), duv1 (2), duv2 (2),
    mat_id (1), mesh_id (1); with `geometry.normals` 9 more columns, n0 (3),
    dn1 (3), dn2 (3) (D = 26).  Built from the vertices as they are (not
    detached), so it is differentiable with respect to them; the uv columns
    are zero when the geometry has no uvs.
    """
    faces = geometry.faces
    b, f = geometry.vertices.shape[0], faces.shape[0]
    v0, e1, e2 = geometry.triangle_corners()
    cols = [v0, e1, e2]
    if geometry.uvs is not None:
        uv0, uv1, uv2 = (geometry.uvs[faces[:, k]] for k in range(3))
        cols += [x.expand(b, f, 2) for x in (uv0, uv1 - uv0, uv2 - uv0)]
    else:
        cols.append(v0.new_zeros(b, f, 6))
    ids = torch.stack([geometry.face_mat, geometry.face_mesh], dim=-1).to(v0.dtype)
    cols.append(ids.expand(b, f, 2))
    if geometry.normals is not None:
        n0, n1, n2 = (geometry.normals[:, faces[:, k]] for k in range(3))
        cols += [n0, n1 - n0, n2 - n0]
    return torch.cat(cols, dim=-1)


def hit_attributes_table(o: Vec3, d: Vec3, hit: Hit, face_table: Tensor, has_uvs: bool,
                         has_normals: bool = False) -> dict:
    """Hit attributes re-derived from one row gather of the face table.

    o, d: Vec3 of (B, N) components (differentiable); `hit` the detached
    traversal output.  Returns position, normal (unit e1 x e2), t, u, v,
    mat_id and mesh_id, with `has_uvs` uv_x, uv_y and the uv-derived
    tangent, with `has_normals` the interpolated smooth_normal.  Miss lanes
    are pinned to u = v = 0, t = 1 (the position of p0), so no 0 * inf
    reaches the backward.  The gather's backward adds rows into the table
    (an atomic index_add_ on the card).
    """
    b, f, dim = face_table.shape
    prim = hit.prim.clamp(min=0).long()
    flat = (prim + torch.arange(b, device=prim.device)[:, None] * f).reshape(-1)
    row = face_table.reshape(b * f, dim).index_select(0, flat).reshape(*prim.shape, dim)

    def col(k):
        return row[..., k]

    def vec(k):
        return Vec3(row[..., k], row[..., k + 1], row[..., k + 2])

    p0, e1, e2 = vec(0), vec(3), vec(6)
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    near0 = det.abs() < _EPS_DET
    inv_det = torch.where(near0, 0.0, 1.0 / torch.where(near0, 1.0, det))
    tvec = o - p0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    u = torch.where(hit.valid, u, 0.0)
    v = torch.where(hit.valid, v, 0.0)
    t = torch.where(hit.valid, t, 1.0)

    normal = e1.cross(e2).normalized()
    out = {
        "position": p0 + e1 * u + e2 * v,
        "normal": normal,
        "t": t,
        "u": u,
        "v": v,
        "mat_id": col(15).long(),
        "mesh_id": col(16).long(),
    }
    if has_uvs:
        d1x, d1y, d2x, d2y = col(11), col(12), col(13), col(14)
        out["uv_x"] = col(9) + u * d1x + v * d2x
        out["uv_y"] = col(10) + u * d1y + v * d2y
        det_uv = d1x * d2y - d1y * d2x
        flat_uv = det_uv.abs() < 1e-12
        inv = torch.where(flat_uv, 0.0, 1.0 / torch.where(flat_uv, 1.0, det_uv))
        out["tangent"] = (e1 * d2y - e2 * d1y) * inv
    if has_normals:
        out["smooth_normal"] = _interp_smooth_normal(vec(17), vec(20), vec(23), u, v, normal)
    return out


def _interp_smooth_normal(n0: Vec3, dn1: Vec3, dn2: Vec3, u: Tensor, v: Tensor,
                          geometric: Vec3) -> Vec3:
    """The unit Phong-interpolated normal n0 + u dn1 + v dn2, or the
    geometric normal where the interpolation is (near) zero: all-zero rows
    mark flat-shaded meshes, and unit corner normals cancel only across a
    fold beyond 120 degrees.  The rsqrt's radicand is max-guarded, so zero
    rows keep a finite cotangent."""
    nsm = n0 + dn1 * u + dn2 * v
    nn2 = nsm.norm2()
    ok = nn2 > 1e-6
    nsm = nsm * rsqrt(torch.clamp(nn2, min=1e-12))
    return v3_where(ok, nsm, geometric)
