"""Delta-emitter evaluation: point / spot lights and the analytic beam-splat
projector (port of fireflies_tpu/render/lights.py; envmap, area lights and
the projector texture route are not ported yet).

Shading points are Vec3s of (B, N) components; per-variant emitter data
has a leading B axis and is splatted to (B, 1).  Spot and projector
emitters look down their local -Z.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from fireflies_tpu_torch.render.types import LIGHT_SPOT, Lights, Projector
from fireflies_tpu_torch.render.vec3 import Vec3, splat

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


def eval_projector_v(projector: Projector, p: Vec3):
    """Projector in analytic beam mode at points p: (wi, dist, rad)."""
    if projector.beams_ndc is None or projector.texture is not None:
        raise NotImplementedError("only the analytic beam-splat projector is ported")
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

    h_px, w_px = projector.beam_hw
    g = _beam_splat_field(ndc_x, ndc_y, projector.beams_ndc, projector.beam_sigma,
                          0.5 * w_px, 0.5 * h_px)
    color = projector.beam_color
    tex = Vec3(color[:, 0, None] * g, color[:, 1, None] * g, color[:, 2, None] * g)

    in_frustum = ((depth > projector.near[:, None]) & (depth < projector.far[:, None])
                  & (ndc_x.abs() <= 1.0) & (ndc_y.abs() <= 1.0))
    inv_r2 = 1.0 / torch.clamp(dist * dist, min=1e-12)
    radiance = tex * torch.where(in_frustum, projector.scale[:, None] * inv_r2, 0.0)
    return wi, dist, radiance


def total_incident_v(lights: Lights, projector: Optional[Projector], p: Vec3):
    """Every delta emitter at p, in light-slot order then the projector:
    lists of (wi, dist, rad)."""
    acc = [eval_light_v(lights, i, p) for i in range(lights.count)]
    if projector is not None:
        acc.append(eval_projector_v(projector, p))
    return [a[0] for a in acc], [a[1] for a in acc], [a[2] for a in acc]


def emitter_positions(lights: Lights, projector: Optional[Projector]) -> list[Tensor]:
    """(B, 3) world position of every delta emitter, in total_incident order."""
    positions = [lights.to_world[:, i, :3, 3] for i in range(lights.count)]
    if projector is not None:
        positions.append(projector.to_world[:, :3, 3])
    return positions


def emitter_apertures(lights: Lights, projector: Optional[Projector]) -> list:
    """Soft-shadow aperture spec per delta emitter, in total_incident order:
    None (hard shadow) or (radius, x_axis, y_axis), per-variant tensors."""
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
