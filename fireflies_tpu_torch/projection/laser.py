"""Laser pattern generators and projector textures (port of the main-path
part of fireflies_tpu/projection/laser.py).

Laser-local space looks down -Z (like the camera); generators return unit
direction vectors (K, 3).  Two projector routes carry the pattern into
SceneBridge.assemble, both differentiable with respect to the beam
directions: `rays_to_beam_params` gives the analytic beam-splat entries,
`rays_to_texture_rgb` the rasterized (H, W, 3) texture for "tex.data".
The pure ray operations place beams in the world and keep an optimized
pattern inside the projector's field of view (`clamp_rays_to_fov`, and the
respawns, which draw fresh beams from a torch.Generator).
"""

from __future__ import annotations

import torch

from fireflies_tpu_torch.graphics import rasterization
from fireflies_tpu_torch.postprocessing import gaussian_blur2d
from fireflies_tpu_torch.projection.camera import directions_to_ndc, ndc_to_directions
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor


def generate_uniform_rays(intra_ray_angle: float, num_beams_x: int, num_beams_y: int,
                          device="cuda") -> Tensor:
    """Angle-equispaced grid: direction (tan((i - c) a), tan((j - c) a), -1),
    normalized; (num_beams_x * num_beams_y, 3) on `device` (the card unless
    the caller asks for the CPU)."""
    ix = torch.arange(num_beams_x, dtype=torch.float32, device=device) - (num_beams_x - 1) / 2.0
    iy = torch.arange(num_beams_y, dtype=torch.float32, device=device) - (num_beams_y - 1) / 2.0
    tx = torch.tan(ix * intra_ray_angle)
    ty = torch.tan(iy * intra_ray_angle)
    gx, gy = torch.meshgrid(tx, ty, indexing="ij")
    d = torch.stack([gx.reshape(-1), gy.reshape(-1), -torch.ones_like(gx.reshape(-1))], -1)
    return ffmath.normalize_vectors(d)


def rays_to_world(rays_local: Tensor, to_world: Tensor) -> Tensor:
    """Local beam directions (..., K, 3) -> unit world directions under the
    pose `to_world` (..., 4, 4)."""
    return ffmath.normalize_vectors(ffmath.transform_directions(rays_local, to_world))


def origin_per_ray(to_world: Tensor, n: int) -> Tensor:
    """The pose's origin repeated for n beams: (..., n, 3)."""
    origin = to_world[..., :3, 3]
    return origin[..., None, :].expand(*origin.shape[:-1], n, 3)


def clamp_rays_to_fov(rays_local: Tensor, fov_deg: float, clamp_val: float = 0.95) -> Tensor:
    """Pull beams outside the frustum back to the NDC border +-clamp_val."""
    ndc = directions_to_ndc(rays_local, fov_deg).clamp(-clamp_val, clamp_val)
    return ndc_to_directions(ndc, fov_deg)


def _respawn(gen: torch.Generator, rays_local: Tensor, oob: Tensor, fov_deg: float) -> Tensor:
    """The beams with `oob` rows replaced by fresh NDC points, uniform in
    [-1, 1)^2 (drawn for every row from `gen`, which lives on the rays'
    device)."""
    fresh = torch.rand((rays_local.shape[0], 2), generator=gen, device=rays_local.device) * 2 - 1
    ndc = torch.where(oob[:, None], fresh, directions_to_ndc(rays_local, fov_deg))
    return ndc_to_directions(ndc, fov_deg)


def respawn_out_of_bounds(gen: torch.Generator, rays_local: Tensor, fov_deg: float) -> Tensor:
    """Replace beams outside the projector's NDC square with fresh uniform
    ones; the others keep their NDC point."""
    oob = (directions_to_ndc(rays_local, fov_deg).abs() >= 1.0).any(dim=-1)
    return _respawn(gen, rays_local, oob, fov_deg)


def respawn_out_of_camera(gen: torch.Generator, rays_local: Tensor, camera_ndc: Tensor,
                          fov_deg: float) -> Tensor:
    """Replace beams whose camera-space NDC point `camera_ndc` (K, 2+) left
    the camera's view with fresh uniform ones."""
    oob = (camera_ndc[:, :2].abs() >= 1.0).any(dim=-1)
    return _respawn(gen, rays_local, oob, fov_deg)


def rays_to_beam_params(
    rays_local: Tensor,
    fov_deg: float,
    sigma: float = 10.0,
    texture_size=(256, 256),
    color=(0.0, 1.0, 0.0),
) -> dict:
    """Analytic-projector param entries for SceneBridge.assemble: the (K, 2)
    projector-NDC beam coordinates, the splat sigma (squared-pixel units of
    `texture_size`) and the beam colour."""
    dev = rays_local.device
    return {
        "tex.beams": directions_to_ndc(rays_local, fov_deg),
        "tex.beam_sigma": torch.tensor(sigma, dtype=torch.float32, device=dev),
        "tex.beam_color": torch.tensor(color, dtype=torch.float32, device=dev),
        "tex.beam_hw": (int(texture_size[0]), int(texture_size[1])),
    }


def _texture_points(rays_local: Tensor, fov_deg: float) -> Tensor:
    """Beam directions -> (K, 2) texture points in [0, 1]^2 (v down)."""
    ndc = directions_to_ndc(rays_local, fov_deg)
    return torch.stack([(ndc[:, 0] + 1.0) * 0.5, (1.0 - ndc[:, 1]) * 0.5], -1)


def rays_to_texture(rays_local: Tensor, fov_deg: float, sigma: float, texture_size) -> Tensor:
    """(K, H, W) Gaussian splat stack of the beam pattern."""
    return rasterization.rasterize_points(_texture_points(rays_local, fov_deg), sigma,
                                          texture_size)


def rays_to_texture_summed(rays_local: Tensor, fov_deg: float, sigma: float, texture_size,
                           chunk: int = 64) -> Tensor:
    """(H, W) summed pattern texture, without the (K, H, W) stack."""
    return rasterization.sum_points(_texture_points(rays_local, fov_deg), sigma, texture_size,
                                    chunk=chunk)


def rays_to_texture_rgb(
    rays_local: Tensor,
    fov_deg: float,
    sigma: float,
    texture_size,
    color=(0.0, 1.0, 0.0),
    blur_kernel: int = 5,
    blur_sigma: float = 3.0,
    chunk: int = 64,
) -> Tensor:
    """The projector texture of the reference main loop: summed beam splats,
    a Gaussian blur (none when `blur_kernel` is 0), times the colour; an
    (H, W, 3) texture for params["tex.data"]."""
    tex = rays_to_texture_summed(rays_local, fov_deg, sigma, texture_size, chunk=chunk)
    if blur_kernel and blur_sigma > 0:
        tex = gaussian_blur2d(tex, (blur_kernel, blur_kernel), (blur_sigma, blur_sigma))
    color = torch.tensor(color, dtype=torch.float32, device=rays_local.device)
    return tex[..., None] * color
