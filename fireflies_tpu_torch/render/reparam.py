"""Warped-area reparameterized visibility gradients (port of
fireflies_tpu/render/reparam.py).

Silhouette gradients for screen-space integrals after the warp-field
construction of Bangaru, Li & Durand 2020 ("Unbiased Warped-Area
Sampling"), formulated in NDC:

    dI/dtheta = E[ d/dtheta ( f(u + W) * (1 + div_u W) ) ],
    W = V(u; theta) - detach(V)              (primal zero)

V is a smooth screen-space velocity field built per pixel from K auxiliary
rays in an NDC disk (`make_warp_field`): each aux ray contributes the NDC
position of its hit's material point (barycentrics from detached vertices,
vertices live), the planes the sibling aux rays hit extend across
silhouettes, and with light positions every blocked aux contributes a
shadow candidate through its blocker's plane.  Contributions combine with
boundary-concentrating harmonic weights, so V approaches the edge velocity
at silhouettes.  The reference module's docstrings give the derivations and
the measurements behind each rule; the port keeps every rule as it is.

Every tensor carries the leading variant axis B (u (B, N, 2), vertices
(B, V, 3)); the topology is shared.  The port differs from the reference
in how the work is laid out, not in what it computes:

  * the m = k_aux + n_scout slots are one tensor axis (pixels, slots, aux
    rays), not a scan, so a warp evaluation's launch count does not grow
    with m (it is still thousands of small elementwise launches a chunk
    with its double backward); the sums over slots run in another order;
  * the per-face tables (corners, edge neighbours, the camera's NDC of
    every vertex) are built once per warp, and the camera's inverse once;
  * the divergence div_u V is two reverse passes with `create_graph`
    (the warp is row-wise: each output row reads only its own u row, and
    the constellation is drawn outside), where the reference takes two
    forward-mode probes;
  * `_WarpArea` returns (u, 1) without running the warp, the values the
    reference's u + (V - V) and 1 + (div - div) take for finite V, and
    recomputes the warp chunk by chunk in its backward, pulling (du, d
    area) back to the geometry, the camera, the light positions and, for
    `reparam_direction`, the ray origins and directions.  Peak memory
    follows the chunk, not the film, as the reference's checkpointed map.

The auxiliary and shadow-feature rays go through `intersect.closest_hit`
(B1 from a shared origin: the camera or a light; per-ray origins for the
indirect warp), detached; only their primitive ids are used.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fireflies_tpu_torch.render.intersect import closest_hit, hit_attributes
from fireflies_tpu_torch.render.rays import pixel_to_ndc, rays_from_ndc, uniform
from fireflies_tpu_torch.render.types import Camera, Geometry, RenderConfig, RenderScene
from fireflies_tpu_torch.render.vec3 import Vec3, from_array

Tensor = torch.Tensor

_EPS_DET = 1e-9


def _edge_topology(geometry: Geometry) -> tuple[Tensor, Tensor]:
    """Edge openness and adjacency: (open (F, 3) bool, nbr (F, 3) int64),
    edges in the barycentric-distance order [v, w, u] (p0-p1, p1-p2,
    p2-p0).  Open edges (used by one face) are warp boundaries; `nbr` is
    the face across each shared edge (-1 on open edges).  One stable sort
    of the int64 key lo * V + hi, the reference's (lo, hi) lexsort."""
    f = geometry.faces.long()
    n_faces = f.shape[0]
    pairs = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], dim=0)  # (3F, 2)
    lo = torch.minimum(pairs[:, 0], pairs[:, 1])
    hi = torch.maximum(pairs[:, 0], pairs[:, 1])
    key = lo * (int(f.max()) + 1 if n_faces else 1) + hi
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    idx = torch.arange(key.shape[0], device=f.device)
    adj_same = key_s[1:] == key_s[:-1]
    no = adj_same.new_zeros(1)
    same_next = torch.cat([adj_same, no])
    same_prev = torch.cat([no, adj_same])
    partner_sorted = torch.where(same_next, idx + 1, torch.where(same_prev, idx - 1, idx))
    partner = order[partner_sorted]
    inv = torch.empty_like(order)
    inv[order] = idx
    partner_of = partner[inv]
    open_flat = partner_of == idx
    nbr_flat = torch.where(open_flat, -1, partner_of % n_faces)
    return open_flat.reshape(3, -1).T, nbr_flat.reshape(3, -1).T


def _n_scout(k_aux: int) -> int:
    return max(6, k_aux // 2)


def _norm(v: Vec3) -> Tensor:
    return torch.sqrt(v.norm2())


def _vec(row: Tensor, k: int) -> Vec3:
    return Vec3(row[..., k], row[..., k + 1], row[..., k + 2])


class _Tables:
    """The per-warp face tables, rows flattened over the variants (row
    b * F + f): live corners (B*F, 9) and their detached copy, the
    detached vertices (B*V, 3), edge openness (F, 3), and for the boundary
    metric each face's corner ids (F, 3) and its edge neighbours' open
    edges as vertex-id pairs (F, E, 2) with their mask (F, E), E the most
    any face has (the reference's 9 neighbour edges, the shared ones
    masked out)."""

    def __init__(self, geometry: Geometry, topology):
        faces = geometry.faces.long()
        v = geometry.vertices
        b, n_v = v.shape[:2]
        self.n_faces, self.n_verts = faces.shape[0], n_v
        self.tri = torch.cat([v[:, faces[:, k]] for k in range(3)], dim=-1).reshape(-1, 9)
        self.tri_det = self.tri.detach()
        self.vertices_det = v.detach().reshape(b * n_v, 3)
        edge_open, nbrs = topology
        self.edge_open = edge_open
        self.faces = faces
        nid = nbrs.clamp(min=0)
        nface = faces[nid]  # (F, 3 neighbours, 3 corners)
        ends = torch.stack([nface, nface.roll(-1, dims=-1)], dim=-1).reshape(-1, 9, 2)
        use = (edge_open[nid] & (nbrs >= 0)[..., None]).reshape(-1, 9)
        n_use = int(use.sum(1).max()) if use.numel() else 0
        # Each face's used neighbour edges first, in the reference's order.
        order = torch.argsort((~use).to(torch.int8), dim=1, stable=True)[:, :n_use]
        self.nbr_ends = torch.gather(ends, 1, order[..., None].expand(-1, -1, 2))
        self.nbr_use = torch.gather(use, 1, order)

    def rows(self, bi: Tensor, face: Tensor) -> Tensor:
        return bi * self.n_faces + face

    def verts(self, bi: Tensor, vid: Tensor) -> Tensor:
        return bi.reshape(*bi.shape, *[1] * (vid.dim() - bi.dim())) * self.n_verts + vid


def _plane_eval(o: Vec3, d: Vec3, rows: Tensor, tables: _Tables, face: Tensor) -> dict:
    """Rays against the (extended) plane of the faces at flat table rows
    `rows`: barycentrics from the detached vertices and the live rays, so
    they may leave [0, 1] and cross an edge smoothly; x the live material
    point.  o, d broadcast against rows; returns x, x_det (Vec3), t,
    graze and opens over the broadcast shape."""
    p = tables.tri.index_select(0, rows.reshape(-1)).reshape(*rows.shape, 9)
    q = tables.tri_det.index_select(0, rows.reshape(-1)).reshape(*rows.shape, 9)
    q0, q1, q2 = _vec(q, 0), _vec(q, 3), _vec(q, 6)
    e1, e2 = q1 - q0, q2 - q0
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    near0 = det.abs() < _EPS_DET
    inv_det = torch.where(near0, 0.0, 1.0 / torch.where(near0, 1.0, det))
    tvec = o - q0
    bu = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    bv = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    bw = 1.0 - bu - bv
    p0, p1, p2 = _vec(p, 0), _vec(p, 3), _vec(p, 6)
    x = p0 * bw + p1 * bu + p2 * bv
    n_tri = (p1 - p0).cross(p2 - p0)
    n_tri = n_tri * (1.0 / (_norm(n_tri) + 1e-20))
    with torch.no_grad():
        graze = n_tri.dot(d * (1.0 / (_norm(d) + 1e-20))).abs()
    return {"x": x, "x_det": q0 * bw + q1 * bu + q2 * bv, "t": t, "graze": graze,
            "opens": tables.edge_open[face], "n": n_tri}


def _seg_dist(p: Tensor, s0: Tensor, s1: Tensor) -> Tensor:
    """Exact 2D point-to-segment distance, (...) from (..., 2) points.  The
    radicand is max-guarded (not a norm, whose backward divides by the
    distance: a sample can land exactly on a segment)."""
    e = s1 - s0
    tt = ((p - s0) * e).sum(-1) / torch.clamp((e * e).sum(-1), min=1e-18)
    tt = torch.minimum(torch.maximum(tt, torch.zeros_like(tt)), torch.ones_like(tt))
    proj = s0 + tt[..., None] * e
    d2 = ((p - proj) ** 2).sum(-1)
    return torch.sqrt(torch.clamp(d2, min=1e-24))


def _screen_boundary(p: Tensor, corners: Tensor, nbr_ends: Tensor, graze: Tensor, opens: Tensor,
                     nbr_use: Tensor, win: float) -> Tensor:
    """Screen-space distance of points p (..., 2) to their triangle's
    boundary: the min over edge segments of the triangle's own edges
    (corners (..., 3, 2); the shared ones with the grazing penalty 4 win
    |cos|) and its edge neighbours' open edges (nbr_ends (..., E, 2, 2),
    masked by nbr_use (..., E)), all broadcast against p."""
    a, b, c = corners[..., 0, :], corners[..., 1, :], corners[..., 2, :]
    d = torch.stack([_seg_dist(p, a, b), _seg_dist(p, b, c), _seg_dist(p, c, a)], dim=-1)
    pen = graze[..., None] * (4.0 * win)
    best = torch.amin(d + torch.where(opens, 0.0, pen), dim=-1)
    if nbr_ends.shape[-3]:
        nd = _seg_dist(p[..., None, :], nbr_ends[..., 0, :], nbr_ends[..., 1, :])
        best = torch.minimum(best, torch.amin(torch.where(nbr_use, nd, math.inf), dim=-1))
    return best


class CameraDomain:
    """Warp domain over the camera's NDC film plane (the default).  Points
    project to NDC through the camera's inverse, taken once, with each
    row's variant `bi`."""

    def __init__(self, camera: Camera):
        self._camera = camera
        self._inv = torch.linalg.inv(camera.to_world)
        self._tan = torch.tan(torch.deg2rad(camera.fov) / 2.0)
        self.shared_origin = camera.to_world[:, :3, 3]

    def rays(self, u: Tensor):
        """NDC points (B, n, m, 2) -> rays (o, d), each (B, n, m, 3)."""
        b = u.shape[0]
        o, d = rays_from_ndc(self._camera, u.reshape(b, -1, 2))
        return o.reshape(*u.shape[:-1], 3), d.reshape(*u.shape[:-1], 3)

    def project(self, pts: Vec3, bi: Tensor, ii: Tensor) -> Tensor:
        """Points (Vec3 of (...)) of variants bi -> NDC (..., 2), the
        arithmetic of rays.points_to_ndc on components."""
        m = self._inv[bi]
        while m.dim() - 2 < pts.x.dim():
            m = m.unsqueeze(-3)
        r = [m[..., k, 0] * pts.x + m[..., k, 1] * pts.y + m[..., k, 2] * pts.z + m[..., k, 3]
             for k in range(4)]
        w = torch.where(r[3].abs() < 1e-8, torch.where(r[3] < 0, -1e-8, 1e-8), r[3])
        depth = -(r[2] / w)
        tan = self._tan[bi]
        while tan.dim() < pts.x.dim():
            tan = tan.unsqueeze(-1)
        safe = torch.where(depth.abs() < 1e-8, 1e-8, depth)
        return torch.stack([(r[0] / w) / (safe * tan), (r[1] / w) / (safe * tan)], dim=-1)

    def vertex_table(self, tables: _Tables):
        """(B*V, 2) NDC of every detached vertex, projected once."""
        b = self._inv.shape[0]
        bi = torch.arange(b, device=self._inv.device)[:, None].expand(b, tables.n_verts)
        return self.project(from_array(tables.vertices_det), bi.reshape(-1), None)


class DirectionDomain:
    """Per-ray gnomonic tangent-plane domain around central directions,
    for indirect (BSDF-sampled) bounces: each origin x_i gets a 2D patch
    around its direction w_i, direction(u) = normalize(w + t u_x + b u_y)
    (a Frisvad basis t, b around w), project() the matching gnomonic map.
    x, w (B, n, 3)."""

    def __init__(self, x: Tensor, w: Tensor):
        wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
        sign = torch.where(wz >= 0.0, 1.0, -1.0)
        a = -1.0 / (sign + wz)
        b_ = wx * wy * a
        self._x = x
        self._w = w
        self._t = torch.stack([1.0 + sign * wx * wx * a, sign * b_, -sign * wx], -1)
        self._b = torch.stack([b_, sign + wy * wy * a, -wy], -1)
        self.shared_origin = None

    def rays(self, u: Tensor):
        """Patch coordinates (B, n, m, 2) -> rays (o, d), each (B, n, m, 3)."""
        w, t, b = (v[:, :, None] for v in (self._w, self._t, self._b))
        d = w + t * u[..., 0:1] + b * u[..., 1:2]
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-20)
        return self._x[:, :, None].expand_as(d), d

    def direction(self, u: Tensor) -> Tensor:
        """(B, n, 2) central-patch coords -> (B, n, 3) unit directions."""
        d = self._w + self._t * u[..., 0:1] + self._b * u[..., 1:2]
        return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-20)

    def project(self, pts: Vec3, bi: Tensor, ii: Tensor) -> Tensor:
        def frame(v):
            f = from_array(v[bi, ii])
            while f.x.dim() < pts.x.dim():
                f = Vec3(*(c.unsqueeze(-1) for c in f))
            return f

        v = pts - frame(self._x)
        z = v.dot(frame(self._w))
        z = torch.where(z.abs() < 1e-8, 1e-8, z)
        return torch.stack([v.dot(frame(self._t)) / z, v.dot(frame(self._b)) / z], -1)

    def vertex_table(self, tables: _Tables):
        return None  # the projection depends on the ray's frame


def _constellation(xi: Tensor, k_aux: int, radius: float, scout_mult: float) -> Tensor:
    """The aux offsets (B, 1, m, 2) from the uniforms xi (B, 1, m, 2): the
    k_aux candidates on jittered strata over the full circle in antithetic
    pairs, the scouts at mid-stratum angles on the wider ring."""
    n_scout = _n_scout(k_aux)
    m = k_aux + n_scout
    dev = xi.device
    ar = torch.arange(m, device=dev)
    is_cand = ar < k_aux
    group_idx = torch.where(is_cand, ar, ar - k_aux)
    group_n = torch.where(is_cand, k_aux, n_scout)
    half = max(1, k_aux // 2)
    pair_idx = torch.where(is_cand, ar % half, 0)
    sel = torch.where(is_cand, pair_idx, ar)
    xi_ang = xi[..., 0][..., sel]
    xi_rad = xi[..., 1][..., sel]
    mirror = is_cand & (ar >= half)
    jitter = torch.where(is_cand, xi_ang, 0.5)
    base_idx = torch.where(is_cand, pair_idx, group_idx)
    base_n = torch.where(is_cand, half, group_n)
    phi = (2.0 * math.pi * ((jitter + base_idx) / base_n)
           + torch.where(mirror, math.pi, 0.0))
    r = torch.where(is_cand, radius * torch.sqrt(xi_rad),
                    scout_mult * radius * (1.0 + 0.2 * xi_rad))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def _grid(b: int, n: int, m: int, device):
    """Broadcast index grids (bi, ii, ji, ki) over (B, n, J = m, K = m)."""
    ar = lambda k: torch.arange(k, device=device)  # noqa: E731
    return (ar(b).reshape(b, 1, 1, 1), ar(n).reshape(1, n, 1, 1), ar(m).reshape(1, 1, m, 1),
            ar(m).reshape(1, 1, 1, m))


def make_warp_field(camera: Camera | None, geometry: Geometry, gens=None, k_aux: int = 8,
                    radius: float = 0.05, kappa: float = 4.0,
                    light_positions: Tensor | None = None, debug: bool = False, domain=None, uniforms: Tensor | None = None,
                    topology=None, tile_cull: bool = True):
    """Build the screen-space warp V: NDC (B, N, 2) -> NDC velocities
    (B, N, 2), returned in velocity form V - detach(V - u) (primal u).

    Smooth in u and live in the geometry and camera; only the aux rays'
    primitive ids are frozen.  `radius` is the aux disk radius in NDC,
    `kappa` sets how sharply the weights concentrate at boundaries.  With
    `light_positions` (B, L, 3) every blocked aux also contributes a shadow
    candidate.  The constellation is one draw a variant, shared by all
    pixels: (1, m, 2) uniforms from each variant's generator, or the
    given `uniforms` (B or 1, 1, m, 2).  `topology` is `_edge_topology`'s
    result when the caller has it.  With `debug` the warp returns (V,
    dict of its intermediates).

    Extension and shadow features (a plane j of the pixel's m slots
    evaluated along each of its m aux rays k) enter through a window: a
    feature whose boundary distance is at least win = 1.8 radius, or
    whose gate is off, adds exactly nothing, value or derivative.  So each
    feature set is screened without a graph (its gate, then the boundary
    distance where the gate is on), and only the rows inside the window
    are evaluated again with a graph and placed into the (B, n, J, K)
    accumulators, whose other entries are the exact zeros (and win) the
    reference adds for them.  Against one dense pass over every row with a
    graph (the reference's structure), bench's 256^2 pose_reparam step on
    an H100 at 700 W took about the same time (0.204-0.206 against
    0.169-0.223 renders/s) at a sixth of the peak memory (0.556 against
    3.308 GiB), and a CPU step a third of the time (PERF.md).
    """
    if domain is None:
        domain = CameraDomain(camera)
    topology = _edge_topology(geometry) if topology is None else topology
    tables = _Tables(geometry, topology)
    n_scout = _n_scout(k_aux)
    m = k_aux + n_scout
    win = 1.8 * radius
    scout_mult = float(np.ceil(10.0 * (1.1 + win / radius) / np.cos(np.pi / n_scout)) / 10.0)
    fb = (win / 4.0) ** 2
    eta_cap = 1.0 / (win * win + fb)
    dev = geometry.vertices.device
    xi = _constellation_uniforms(gens, k_aux, dev, uniforms)
    offs = _constellation(xi, k_aux, radius, scout_mult)  # (B | 1, 1, m, 2)
    vert_ndc = domain.vertex_table(tables)

    def boundary(p, bi, ii, face, pe, project=None):
        """_screen_boundary of points p (..., 2) on faces `face` of rows
        (bi, ii), the corners mapped by `project` (default: the domain's,
        from the vertex table where it has one)."""
        cv = tables.verts(bi, tables.faces[face])  # (..., 3)
        ev = tables.verts(bi, tables.nbr_ends[face])  # (..., E, 2)
        if project is None and vert_ndc is not None:
            corners, ends = vert_ndc[cv], vert_ndc[ev]
        else:
            project = project or (lambda q: domain.project(q, bi, ii))
            corners = project(from_array(tables.vertices_det[cv]))
            ends = project(from_array(tables.vertices_det[ev.flatten(-2)]))
            ends = ends.unflatten(-2, ev.shape[-2:])
        return _screen_boundary(p, corners, ends, pe["graze"], pe["opens"],
                                tables.nbr_use[face], win)

    def warp(u: Tensor):
        b, n, _ = u.shape
        u_k = u[:, :, None, :] + offs  # (B, n, m, 2), live in u
        o, d = domain.rays(u_k)
        so = domain.shared_origin
        hit = closest_hit(o.reshape(b, -1, 3), d.detach().reshape(b, -1, 3), geometry,
                          shared_origin=None if so is None else so.detach(),
                          tile_cull=tile_cull)
        valid = hit.valid.reshape(b, n, m)
        prim = hit.prim.clamp(min=0).long().reshape(b, n, m)
        o_v, d_v = from_array(o), from_array(d)
        bi, ii, ji, ki = _grid(b, n, m, dev)
        bo, io = bi[..., 0], ii[..., 0]  # the aux rays' own grid over (B, n, m)

        # The carrier: the aux ray's own hit plane, or its own coordinate.
        own = _plane_eval(o_v, d_v, tables.rows(bo, prim), tables, prim)
        ndc0 = domain.project(own["x"], bo, io)
        own_b = boundary(domain.project(own["x_det"], bo, io), bo, io, prim, own)
        val0 = torch.where(valid[..., None], ndc0, u_k)
        b0 = torch.where(valid, torch.clamp(own_b, max=win), win)

        acc = [torch.zeros_like(b0), torch.zeros_like(val0), torch.full_like(b0, win)]

        def add_feature(rows_fn, gate_dbg):
            """Screen the (B, n, J, K) rows of one feature set, evaluate
            the rows inside the window with a graph, and accumulate."""
            with torch.no_grad():
                ok = rows_fn(bi, ii, ji, ki, full=False)
                sel = ok.nonzero(as_tuple=True)
                fbnd_ok = rows_fn(*sel, full=True)[1]
                inside = fbnd_ok < win
                act = tuple(s[inside] for s in sel)
            fv, fbnd = rows_fn(*act, full=True)
            eta = torch.clamp(1.0 / (fbnd * fbnd + fb) - eta_cap, min=0.0)
            shape = (b, n, m, m)
            dense_eta = b0.new_zeros(shape).index_put(act, eta)
            dense_val = b0.new_zeros(*shape, 2).index_put(act, eta[:, None] * fv)
            dense_q = b0.new_full(shape, win).index_put(act, torch.clamp(fbnd, max=win))
            acc[0] = acc[0] + dense_eta.sum(2)
            acc[1] = acc[1] + dense_val.sum(2)
            acc[2] = torch.minimum(acc[2], torch.amin(dense_q, dim=2))
            if gate_dbg is not None:
                full = b0.new_full(shape, math.inf)
                full[sel] = fbnd_ok
                gate_dbg.update(ok=ok, fbnd=full)

        # Primary-silhouette extensions: every aux's plane (slot j) evaluated
        # along every sibling aux ray k.
        def ext_rows(sb, si, sj, sk, full):
            face = prim[sb, si, sj]
            o_r = Vec3(*(c[sb, si, sk] for c in o_v))
            d_r = Vec3(*(c[sb, si, sk] for c in d_v))
            pe = _plane_eval(o_r, d_r, tables.rows(sb, face), tables, face)
            ok = (~(valid[sb, si, sk] & (prim[sb, si, sk] == face)) & valid[sb, si, sj]
                  & (pe["t"] > 1e-4))
            if not full:
                return ok
            fv = domain.project(pe["x"], sb, si)
            fbnd = boundary(domain.project(pe["x_det"], sb, si), sb, si, face, pe)
            return fv, fbnd

        add_feature(ext_rows, None)

        # Shadow features, one set per delta light: each blocked aux's
        # blocker plane evaluated along every sibling's shadow segment.
        shadow_dbg = []
        if light_positions is not None and light_positions.shape[1] > 0:
            x_live = own["x"].to_array()
            x_flat = torch.where(valid[..., None], x_live, x_live.detach())
            x_flat_det = torch.where(valid[..., None], own["x_det"].to_array(), x_live.detach())
            n_recv = own["n"].to_array()
            for li in range(light_positions.shape[1]):
                lpos = light_positions[:, li]  # (B, 3)
                seg = x_flat - lpos[:, None, None, :]  # live in u and theta
                bhit = closest_hit(lpos[:, None, None, :].expand_as(seg).reshape(b, -1, 3),
                                   seg.detach().reshape(b, -1, 3), geometry, t_min=1e-4,
                                   t_max=1.0 - 1e-3, shared_origin=lpos.detach(),
                                   tile_cull=tile_cull)
                blocked = bhit.valid.reshape(b, n, m) & valid
                bprim = bhit.prim.clamp(min=0).long().reshape(b, n, m)

                def shadow_rows(sb, si, sj, sk, full, lpos=lpos, seg=seg, blocked=blocked,
                                bprim=bprim):
                    face = bprim[sb, si, sj]
                    lp = from_array(lpos[sb])
                    seg_r = from_array(seg[sb, si, sk])
                    pe = _plane_eval(lp, seg_r, tables.rows(sb, face), tables, face)
                    t_sb = pe["t"]
                    ok = valid[sb, si, sk] & blocked[sb, si, sj] & (t_sb > 1e-3) & (t_sb < 0.999)
                    if not full:
                        return ok
                    # The blocker-plane point projected through the light
                    # onto the receiver's plane: primal x, moving with the
                    # shadow edge.
                    n_r = from_array(n_recv[sb, si, sk])
                    rel = from_array(x_flat[sb, si, sk]) - lp
                    d_s = pe["x"] - lp
                    denom = n_r.dot(d_s)
                    safe = torch.where(denom.abs() < 1e-9, 1e-9, denom)
                    fv = domain.project(lp + d_s * (n_r.dot(rel) / safe), sb, si)
                    # The boundary metric point: theta-detached, live in u.
                    n_d = Vec3(*(c.detach() for c in n_r))
                    lp_d = Vec3(*(c.detach() for c in lp))
                    dq_det = pe["x_det"] - lp_d
                    den_det = n_d.dot(dq_det)
                    den_det = torch.where(den_det.abs() < 1e-9, 1e-9, den_det)
                    rel_det = from_array(x_flat_det[sb, si, sk]) - lp
                    p_det = domain.project(lp + dq_det * (n_d.dot(rel_det) / den_det), sb, si)
                    rel_c = Vec3(*(c.detach().unsqueeze(-1) for c in rel))
                    n_c = Vec3(*(c.unsqueeze(-1) for c in n_d))
                    lp_c = Vec3(*(c.unsqueeze(-1) for c in lp_d))

                    def shadow_project(q):
                        """Corners (..., C) through the light onto the
                        receiver's plane, then to screen (detached points)."""
                        dq = q - lp_c
                        den = n_c.dot(dq)
                        den = torch.where(den.abs() < 1e-9, 1e-9, den)
                        pt = lp_c + dq * (n_c.dot(rel_c) / den)
                        return domain.project(Vec3(*(c.detach() for c in pt)), sb, si)

                    return fv, boundary(p_det, sb, si, face, pe, shadow_project)

                sdbg = {} if debug else None
                add_feature(shadow_rows, sdbg)
                if debug:
                    shadow_dbg.append(sdbg)

        # The carrier, added last, suppressed by q^2 / (q^2 + fb) so that a
        # plane's carrier and extension weights meet at its silhouette.
        acc_eta, acc_val, q_min = acc
        eta0 = (1.0 / (b0 * b0 + fb)) * (q_min * q_min) / (q_min * q_min + fb)
        acc_eta = acc_eta + eta0
        acc_val = acc_val + eta0[..., None] * val0
        val_k = acc_val / torch.clamp(acc_eta[..., None], min=1e-20)
        b_k = torch.minimum(q_min, b0)

        # Candidates only (the scouts source plane ids and do not vote).
        val_c = val_k[:, :, :k_aux]
        b_c = b_k[:, :, :k_aux]
        oc = offs[:, :, :k_aux]
        d2 = (oc * oc).sum(-1)
        w = 1.0 / (d2 + b_c * b_c + (radius / kappa) ** 2)
        w = w / torch.clamp(w.sum(2, keepdim=True), min=1e-12)
        v_ndc = (w[..., None] * val_c).sum(2)
        out = v_ndc - (v_ndc - u).detach()  # velocity form: primal u
        if debug:
            return out, {"valid": valid, "prim": prim, "own_b": own_b, "b0": b0,
                         "q_min": q_min, "acc_eta": acc_eta, "eta0": eta0, "b_c": b_c,
                         "w": w, "val_c": val_c, "v_ndc": v_ndc, "shadow": shadow_dbg}
        return out

    return warp


def _divergence(warp, u: Tensor):
    """(V, div_u V) at u (B, N, 2), both with a graph to the warp's live
    inputs: the warp is row-wise, so the u-gradient of the sum of V's x
    (y) components is each row's dV_x/du_x (dV_y/du_y)."""
    u_det = u.detach().requires_grad_(True)
    v = warp(u_det)
    gx = torch.autograd.grad(v[..., 0].sum(), u_det, create_graph=True)[0][..., 0]
    gy = torch.autograd.grad(v[..., 1].sum(), u_det, create_graph=True)[0][..., 1]
    return v, gx + gy


class _WarpArea(torch.autograd.Function):
    """(u', area) = (u + W, 1 + div W - detach(div W)) with W = V - detach(V):
    in value u and 1, so the forward runs no warp.  The backward recomputes
    the warp chunk by chunk (`warp_of(leaves)` -> `chunk_warp(u_chunk,
    rows)`) and pulls (du, d area) back to the live inputs; du passes to u
    unchanged (V is evaluated at detached u)."""

    @staticmethod
    def forward(ctx, warp_of, chunk, u, *live):
        ctx.warp_of, ctx.chunk = warp_of, chunk
        ctx.save_for_backward(u, *live)
        return u.clone(), u.new_ones(u.shape[:-1])

    @staticmethod
    def backward(ctx, du, darea):
        u, *live = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        grads = [None] * len(live)
        if any(need):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(bool(nd)) for t, nd in zip(live, need)]
                chunk_warp = ctx.warp_of(leaves)
                want = [i for i, nd in enumerate(need) if nd]
                n = u.shape[1]
                step = ctx.chunk if ctx.chunk and ctx.chunk < n else n
                for c0 in range(0, n, step):
                    rows = slice(c0, c0 + step)
                    v, div = _divergence(lambda uc: chunk_warp(uc, rows), u[:, rows])
                    s = (v * du[:, rows]).sum() + (div * darea[:, rows]).sum()
                    if not s.requires_grad:
                        continue
                    got = torch.autograd.grad(s, [leaves[i] for i in want], retain_graph=True,
                                              allow_unused=True)
                    for i, g in zip(want, got):
                        if g is not None:
                            grads[i] = g if grads[i] is None else grads[i] + g
        du_u = du if ctx.needs_input_grad[2] else None
        return (None, None, du_u, *grads)


def _constellation_uniforms(gens, k_aux: int, device, uniforms) -> Tensor:
    if uniforms is not None:
        return torch.as_tensor(uniforms, dtype=torch.float32, device=device)
    return uniform(gens, (1, k_aux + _n_scout(k_aux), 2), device)


def reparam_ndc(camera: Camera, u: Tensor, geometry: Geometry, gens=None, k_aux: int = 8,
                radius: float = 0.05, kappa: float = 4.0, light_positions: Tensor | None = None,
                chunk: int = 0, uniforms: Tensor | None = None, tile_cull: bool = True):
    """(u', area): NDC samples u (B, N, 2) unchanged in value whose
    gradients carry silhouette motion (primary, and shadow boundaries with
    `light_positions` (B, L, 3)), and the area factor 1 + div_u W (value
    exactly 1).  `chunk` > 0 recomputes the warp in chunks of that many
    rays in the backward (peak memory O(chunk)); the result is the same.
    The constellation: (1, m, 2) uniforms from each variant's generator in
    `gens`, or `uniforms`."""
    xi = _constellation_uniforms(gens, k_aux, u.device, uniforms)
    topology = _edge_topology(geometry)
    live = [geometry.vertices, camera.to_world, camera.fov]
    if light_positions is not None:
        live.append(light_positions)

    def warp_of(leaves):
        verts, to_world, fov, *lp = leaves
        warp = make_warp_field(camera.replace(to_world=to_world, fov=fov),
                               geometry.replace(vertices=verts), k_aux=k_aux, radius=radius,
                               kappa=kappa, light_positions=lp[0] if lp else None,
                               uniforms=xi, topology=topology, tile_cull=tile_cull)
        return lambda uc, rows: warp(uc)

    return _WarpArea.apply(warp_of, chunk, u, *live)


def reparam_direction(x: Tensor, w: Tensor, geometry: Geometry, gens=None, k_aux: int = 6,
                      radius: float = 0.15, kappa: float = 4.0, chunk: int = 0,
                      uniforms: Tensor | None = None, tile_cull: bool = True):
    """Warped-area reparameterization of per-ray directions, the indirect
    bounce's counterpart of reparam_ndc: origins x (B, N, 3) (offset off
    the surface), unit central directions w (B, N, 3).  Returns (d', area):
    directions equal in value to w whose gradients carry the motion of
    occluder silhouettes as seen from x, and the gnomonic area factor
    (value exactly 1).  Keep `radius` small (the reference measured the
    captured flux falling with it: -12% at 0.08, -28% at 0.15 on its
    blocker scene); the path tracer passes `reparam_ind_radius`."""
    xi = _constellation_uniforms(gens, k_aux, x.device, uniforms)
    topology = _edge_topology(geometry)
    u0 = x.new_zeros(*x.shape[:-1], 2)

    def warp_of(leaves):
        verts, xl, wl = leaves
        geo = geometry.replace(vertices=verts)

        def chunk_warp(uc, rows):
            dom = DirectionDomain(xl[:, rows], wl[:, rows])
            return make_warp_field(None, geo, k_aux=k_aux, radius=radius, kappa=kappa,
                                   domain=dom, uniforms=xi, topology=topology,
                                   tile_cull=tile_cull)(uc)

        return chunk_warp

    u_new, area = _WarpArea.apply(warp_of, chunk, u0, geometry.vertices, x, w)
    return DirectionDomain(x, w).direction(u_new), area


def render_depth_reparam(scene: RenderScene, config: RenderConfig, gens=None, k_aux: int = 8,
                         radius: float = 0.05, kappa: float = 4.0,
                         uniforms: Tensor | None = None) -> Tensor:
    """(B, H, W) depth maps whose gradients include primary-silhouette
    terms; in value the depth at the pixel centres (0 on a miss).  `gens`
    (or `uniforms`) draw the warp's constellation."""
    w, h = config.width, config.height
    dev = scene.geometry.vertices.device
    b = scene.batch
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(w, dtype=torch.float32, device=dev) + 0.5, indexing="ij")
    u = pixel_to_ndc(px.reshape(-1), py.reshape(-1), w, h).expand(b, -1, -1)
    u_rep, area = reparam_ndc(scene.camera, u, scene.geometry, gens, k_aux=k_aux, radius=radius,
                              kappa=kappa, uniforms=uniforms, tile_cull=config.tile_cull)
    o, d = rays_from_ndc(scene.camera, u_rep)
    hit = closest_hit(o, d.detach(), scene.geometry, shared_origin=scene.camera.to_world[:, :3, 3],
                      tile_cull=config.tile_cull)
    t = hit_attributes(o, d, hit, scene.geometry)["t"]
    depth = torch.where(hit.valid, t, 0.0) * area
    return depth.reshape(b, h, w)

