"""Emitters (port of fireflies_tpu/render/lights.py): the delta emitters
(point and spot lights, the projector as an analytic beam splat or a
texture) with their soft-shadow apertures, the envmap's importance
sampling for NEE, and area lights (emissive faces).

Shading points are Vec3s of (B, N) components; per-variant emitter data
has a leading B axis and is splatted to (B, 1); the envmap is shared by
every variant.  Spot and projector emitters look down their local -Z.  The
samplers draw from one torch.Generator per variant, or take the draws as
`uniforms`, laid out as the reference splits its key.
"""

from __future__ import annotations

import math

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from fireflies_tpu_torch.render.rays import uniform
from fireflies_tpu_torch.render.texture import bilinear_sample, bilinear_sample_packed
from fireflies_tpu_torch.render.types import LIGHT_SPOT, Geometry, Lights, Materials, Projector
from fireflies_tpu_torch.render.vec3 import Vec3, rsqrt, splat

Tensor = torch.Tensor


def _beam_splat_one(ndc_x: Tensor, ndc_y: Tensor, beams_ndc: Tensor, beam_sigma: Tensor,
                    half_w: float, half_h: float) -> Tensor:
    dx = (beams_ndc[:, 0, None] - ndc_x[None, :]) * half_w  # (K, N)
    dy = (beams_ndc[:, 1, None] - ndc_y[None, :]) * half_h
    d2 = dx * dx + dy * dy
    return torch.exp(-torch.square(d2 / beam_sigma)).sum(dim=0)


def _beam_splat_field(ndc_x: Tensor, ndc_y: Tensor, beams_ndc: Tensor, beam_sigma: Tensor,
                      half_w: float, half_h: float) -> Tensor:
    """Sum-of-Gaussians beam splat g(p) = sum_k exp(-((d_px^2)/sigma)^2).

    ndc_x/ndc_y (B, N), beams_ndc (B, K, 2), beam_sigma (B,) -> (B, N).
    Evaluated per variant as a (K, N) broadcast-reduce under
    torch.utils.checkpoint: the (K, N) residuals would otherwise be kept
    for backward once per spp sample and bounce; recomputing them in
    backward is cheap elementwise work.
    """
    out = []
    for b in range(ndc_x.shape[0]):
        args = (ndc_x[b], ndc_y[b], beams_ndc[b], beam_sigma[b], half_w, half_h)
        if torch.is_grad_enabled():
            out.append(checkpoint(_beam_splat_one, *args, use_reentrant=False))
        else:
            out.append(_beam_splat_one(*args))
    return torch.stack(out)


def spot_falloff(cos_angle: Tensor, cutoff_cos: Tensor, beam_cos: Tensor) -> Tensor:
    """1 inside the beam, linear in cosine down to the cutoff, 0 outside."""
    denom = torch.clamp(beam_cos - cutoff_cos, min=1e-6)
    return torch.clamp((cos_angle - cutoff_cos) / denom, 0.0, 1.0)


def eval_light_v(lights: Lights, index: int, p: Vec3):
    """Light slot `index` at points p: (wi: Vec3, dist (B, N), rad: Vec3)."""
    to_world = lights.to_world[:, index]  # (B, 4, 4)
    pos = splat(to_world[:, :3, 3])
    intensity = splat(lights.intensity[:, index])

    delta = pos - p
    dist = delta.norm()
    wi = delta * (1.0 / (dist + 1e-20))
    inv_r2 = 1.0 / torch.clamp(dist * dist, min=1e-12)
    radiance = intensity * inv_r2

    if lights.kinds[index] == LIGHT_SPOT:
        fwd = splat(-to_world[:, :3, 2])
        falloff = spot_falloff((-wi).dot(fwd), lights.cutoff_cos[:, index, None],
                               lights.beam_cos[:, index, None])
    else:
        falloff = torch.ones_like(dist)
    scale = torch.where(lights.active[:, index, None], falloff, 0.0)
    return wi, dist, radiance * scale


def eval_projector_v(projector: Projector, p: Vec3, tex_table: Optional[Tensor] = None):
    """Projector at points p: (wi, dist, rad).  In texture mode the lookup
    reads `tex_table`, pack_neighborhood_table(projector.texture), when
    given, else the texture itself."""
    to_world = projector.to_world
    pos = splat(to_world[:, :3, 3])
    delta = pos - p
    dist = delta.norm()
    wi = delta * (1.0 / (dist + 1e-20))

    r = torch.linalg.inv(to_world)[..., None]  # (B, 4, 4, 1)
    vx = r[:, 0, 0] * p.x + r[:, 0, 1] * p.y + r[:, 0, 2] * p.z + r[:, 0, 3]
    vy = r[:, 1, 0] * p.x + r[:, 1, 1] * p.y + r[:, 1, 2] * p.z + r[:, 1, 3]
    vz = r[:, 2, 0] * p.x + r[:, 2, 1] * p.y + r[:, 2, 2] * p.z + r[:, 2, 3]
    depth = -vz
    tan_half = torch.tan(torch.deg2rad(projector.fov) / 2.0)[:, None]
    safe = torch.where(depth < 1e-6, 1e-6, depth)
    ndc_x = vx / (safe * tan_half)
    ndc_y = vy / (safe * tan_half)

    if projector.beams_ndc is not None:
        h_px, w_px = projector.beam_hw
        g = _beam_splat_field(ndc_x, ndc_y, projector.beams_ndc, projector.beam_sigma,
                              0.5 * w_px, 0.5 * h_px)
        color = projector.beam_color
        tex = Vec3(color[:, 0, None] * g, color[:, 1, None] * g, color[:, 2, None] * g)
    else:
        uv = torch.stack([(ndc_x + 1.0) * 0.5, (ndc_y + 1.0) * 0.5], dim=-1)
        if tex_table is not None:
            h, w = projector.texture.shape[-3:-1]
            rgb = bilinear_sample_packed(tex_table, h, w, uv)
        else:
            rgb = bilinear_sample(projector.texture, uv)
        tex = Vec3(rgb[..., 0], rgb[..., 1], rgb[..., 2])

    in_frustum = ((depth > projector.near[:, None]) & (depth < projector.far[:, None])
                  & (ndc_x.abs() <= 1.0) & (ndc_y.abs() <= 1.0))
    inv_r2 = 1.0 / torch.clamp(dist * dist, min=1e-12)
    radiance = tex * torch.where(in_frustum, projector.scale[:, None] * inv_r2, 0.0)
    return wi, dist, radiance


def total_incident_v(lights: Lights, projector: Optional[Projector], p: Vec3,
                     proj_tex_table: Optional[Tensor] = None):
    """Every delta emitter at p, in light-slot order then the projector:
    lists of (wi, dist, rad)."""
    acc = [eval_light_v(lights, i, p) for i in range(lights.count)]
    if projector is not None:
        acc.append(eval_projector_v(projector, p, tex_table=proj_tex_table))
    return [a[0] for a in acc], [a[1] for a in acc], [a[2] for a in acc]


def emitter_positions(lights: Lights, projector: Optional[Projector]) -> list[Tensor]:
    """(B, 3) world position of every delta emitter, in total_incident order."""
    positions = [lights.to_world[:, i, :3, 3] for i in range(lights.count)]
    if projector is not None:
        positions.append(projector.to_world[:, :3, 3])
    return positions


def emitter_apertures(lights: Lights, projector: Optional[Projector]) -> list:
    """Soft-shadow aperture per delta emitter, in total_incident order: None
    (a hard shadow, traced on the shared-origin route) or (radius (B,),
    x_axis (B, 3), y_axis (B, 3)), the emitter's local XY disk in world
    space, over which the path tracer jitters each shadow ray's origin."""
    out: list = []
    for i in range(lights.count):
        out.append(None if lights.radius is None else
                   (lights.radius[:, i], lights.to_world[:, i, :3, 0],
                    lights.to_world[:, i, :3, 1]))
    if projector is not None:
        out.append(None if projector.aperture is None else
                   (projector.aperture, projector.to_world[:, :3, 0],
                    projector.to_world[:, :3, 1]))
    return out


def envmap_distribution(env_tex: Tensor, eps: float = 0.01) -> dict:
    """Importance-sampling distribution over an (H, W, 3) equirectangular
    envmap.  Cell (i, j) spans theta in pi [i, i+1] / H (from +Y) and u in
    [j, j+1] / W (texture.sample_envmap's texels); its weight is the 3x3
    neighbourhood maximum of the luminance (wrapping in u, clamped at the
    poles) plus eps times its mean, times sin(theta_c).  The maximum keeps
    the pdf positive wherever the bilinear radiance is, and bounds radiance
    over pdf next to a bright texel.  Returns {"cdf": (H*W,) inclusive flat
    CDF, "pmf": (H, W) cell masses, "h": H, "w": W}."""
    h, w = env_tex.shape[0], env_tex.shape[1]
    lum = 0.2126 * env_tex[..., 0] + 0.7152 * env_tex[..., 1] + 0.0722 * env_tex[..., 2]
    lum = torch.clamp(lum, min=0.0)
    lum = torch.maximum(lum, torch.maximum(torch.roll(lum, 1, dims=1), torch.roll(lum, -1, dims=1)))
    shift_up = torch.cat([lum[:1], lum[:-1]], dim=0)
    shift_dn = torch.cat([lum[1:], lum[-1:]], dim=0)
    lum = torch.maximum(lum, torch.maximum(shift_up, shift_dn))
    lum = lum + eps * torch.clamp(lum.mean(), min=1e-12)
    theta_c = math.pi * (torch.arange(h, dtype=torch.float32, device=env_tex.device) + 0.5) / h
    # Summed in float64: a float32 scan rounds differently on the card and
    # the CPU, and a cell boundary that moves by an ulp changes which cell a
    # draw picks.
    weights = (lum * torch.sin(theta_c)[:, None]).double()
    total = torch.clamp(weights.sum(), min=1e-20)
    return {"cdf": (torch.cumsum(weights.reshape(-1), 0) / total).float(),
            "pmf": (weights / total).float(), "h": h, "w": w}


def _envmap_cell_dir(i: Tensor, j: Tensor, ju: Tensor, jv: Tensor, h: int, w: int):
    """Direction components for the jitter (ju, jv) inside cell (i, j), in
    the envmap's frame (theta from +Y, phi = atan2(x, -z))."""
    theta = math.pi * (i.to(torch.float32) + jv) / h
    phi = 2.0 * math.pi * ((j.to(torch.float32) + ju) / w - 0.5)
    st = torch.sin(theta)
    return st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)


def _solid_pdf(pmf_ij: Tensor, theta: Tensor, h: int, w: int) -> Tensor:
    """Cell mass -> solid-angle density: pmf H W / (2 pi^2 sin theta)."""
    return pmf_ij * (h * w) / (2.0 * math.pi * math.pi * torch.clamp(torch.sin(theta), min=1e-6))


def sample_envmap_nee(dist: dict, n_pts: int, gens=None, uniforms=None):
    """One envmap direction per shading point: a cell from the CDF, a
    uniform point inside it.  Returns (wi: Vec3 of (B, N) in the envmap's
    frame, pdf_solid (B, N)); the caller rotates wi to the world and looks
    the radiance up with texture.sample_envmap.  `uniforms`: (u_cell,
    u_jitter, v_jitter), each (B, N), else drawn from `gens`."""
    h, w = dist["h"], dist["w"]
    if uniforms is None:
        u = uniform(gens, (3, n_pts), dist["cdf"].device)
        uniforms = (u[:, 0], u[:, 1], u[:, 2])
    u_cell, ju, jv = uniforms
    idx = torch.searchsorted(dist["cdf"], u_cell.contiguous()).clamp(0, h * w - 1)
    i, j = idx // w, idx % w
    dx, dy, dz = _envmap_cell_dir(i, j, ju, jv, h, w)
    theta = math.pi * (i.to(torch.float32) + jv) / h
    return Vec3(dx, dy, dz), _solid_pdf(dist["pmf"].reshape(-1)[idx], theta, h, w)


def envmap_pdf_of_dir(dist: dict, dx: Tensor, dy: Tensor, dz: Tensor) -> Tensor:
    """The pdf_solid sample_envmap_nee gives an envmap-frame direction: the
    MIS weight's counterpart for BSDF-sampled escapes."""
    h, w = dist["h"], dist["w"]
    inv_len = rsqrt(dx * dx + dy * dy + dz * dz + 1e-20)
    x, y, z = dx * inv_len, dy * inv_len, dz * inv_len
    theta = torch.arccos(y.clamp(-1.0, 1.0))
    phi_u = torch.atan2(x, -z) * (0.5 / math.pi) + 0.5
    i = (theta * (h / math.pi)).long().clamp(0, h - 1)
    j = (phi_u * w).long().clamp(0, w - 1)
    return _solid_pdf(dist["pmf"][i, j], theta, h, w)


def _emissive_triangles(geometry: Geometry):
    """(v0, v1, v2, cross) of the emissive faces, each (B, E, 3), and their
    total area (B,)."""
    ef = geometry.faces[geometry.emissive_faces]
    v0, v1, v2 = (geometry.vertices[:, ef[:, k]] for k in range(3))
    cross = torch.linalg.cross(v1 - v0, v2 - v0)
    areas = 0.5 * cross.norm(dim=-1)
    return v0, v1, v2, cross, areas, torch.clamp(areas.sum(-1), min=1e-12)


def sample_area_light(geometry: Geometry, materials: Materials, p: Tensor, gens=None,
                      uniforms=None):
    """One point on the emissive faces per shading point p (B, N, 3): a face
    by area, a uniform barycentric point on it.  Returns (x (B, N, 3),
    n_l (B, N, 3) the face's unit normal, Le (B, N, 3) its material's
    emission, pdf_area (B, N) the area-measure pdf).  `uniforms`: (u_face,
    u_a, u_b), each (B, N), else drawn from `gens`."""
    b, n_pts = p.shape[0], p.shape[1]
    v0, v1, v2, cross, areas, total = _emissive_triangles(geometry)
    if uniforms is None:
        u = uniform(gens, (3, n_pts), p.device)
        uniforms = (u[:, 0], u[:, 1], u[:, 2])
    u_face, u_a, u_b = uniforms
    cdf = (torch.cumsum(areas.double(), -1) / total[:, None].double()).float()  # as the envmap's
    idx = torch.searchsorted(cdf, u_face.contiguous()).clamp(0, areas.shape[1] - 1)

    def pick(t):
        return torch.gather(t, 1, idx[..., None].expand(b, n_pts, 3))

    su = torch.sqrt(u_a)
    b0 = 1.0 - su
    b1 = u_b * su
    b2 = 1.0 - b0 - b1
    x = b0[..., None] * pick(v0) + b1[..., None] * pick(v1) + b2[..., None] * pick(v2)
    n_l = pick(cross)
    n_l = n_l / (n_l.norm(dim=-1, keepdim=True) + 1e-20)
    mat_id = geometry.face_mat[geometry.emissive_faces][idx]
    emission = torch.gather(materials.emission, 1, mat_id[..., None].expand(b, n_pts, 3))
    pdf_area = torch.ones((b, n_pts), device=p.device) / total[:, None]
    return x, n_l, emission, pdf_area


def area_pdf_of_hit(geometry: Geometry, prim: Tensor) -> Tensor:
    """The area-measure pdf sample_area_light gives a hit on `prim` (B, N):
    1 / total emissive area on emissive faces, else 0 (the MIS weight's
    counterpart for BSDF-sampled hits)."""
    if geometry.emissive_faces is None:
        return torch.zeros(prim.shape, device=prim.device)
    *_, total = _emissive_triangles(geometry)
    is_emissive = torch.zeros(geometry.faces.shape[0], dtype=torch.bool, device=prim.device)
    is_emissive[geometry.emissive_faces] = True
    return torch.where(is_emissive[prim.clamp(min=0).long()], 1.0 / total[:, None], 0.0)
