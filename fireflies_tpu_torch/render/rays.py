"""Camera ray generation and projection (port of fireflies_tpu/render/rays.py).

Camera space looks down -Z, +Y up, x-fov in degrees with square pixels;
pixel (0, 0) is the top-left of the image.  Only the tile-major route is
ported: the film must divide into 128x16-pixel tiles, so the pixel order is
computed arithmetically and undone with a reshape (`unpermute_rows`), and
row-major results go to tile-major order by the inverse reshape
(`permute_rows`, what the warped-area pass needs).
"""

from __future__ import annotations

import torch

from fireflies_tpu_torch.render.types import Camera
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor


class HostDraws(list):
    """Generators on the CPU whose draws a render on another device copies
    there, so that a render on the card takes the draws of the same render
    on the CPU (the comparison of the two needs this).  A render given a
    plain list of generators draws on its own device, and a generator on
    another device is an error."""


def uniform(gens, shape, device) -> Tensor:
    """(B, *shape) U[0, 1) draws on `device`, one generator per variant
    (drawn on the host and copied for `HostDraws`)."""
    if isinstance(gens, HostDraws):
        return torch.stack([torch.rand(shape, generator=g) for g in gens]).to(device)
    return torch.stack([torch.rand(shape, generator=g, device=device) for g in gens])


def camera_rays_tiled(
    camera: Camera,
    width: int,
    height: int,
    gens=None,
    tile: tuple[int, int] = (128, 16),
):
    """Primary rays in tile-major order; returns (o, d, None), each (B, N, 3).

    Consecutive 2048-ray kernel tiles are 128x16-pixel blocks, so a tile's
    directions form a narrow cone (what the culled kernels prune on).  With
    `gens` (one torch.Generator per variant) pixel positions are jittered
    uniformly inside each pixel; otherwise rays pass through pixel centres.
    The third value keeps the reference's (o, d, inv_perm) signature:
    `unpermute_rows` undoes the order with a reshape.
    """
    tw, th = tile
    if width % tw or height % th:
        raise NotImplementedError(
            f"film {width}x{height} must divide into {tw}x{th} tiles")
    device = camera.to_world.device
    b = camera.to_world.shape[0]
    n = width * height
    n_tx = width // tw
    i = torch.arange(n, dtype=torch.int32, device=device)
    tile_id = i // (tw * th)
    within = i % (tw * th)
    px = ((tile_id % n_tx) * tw + within % tw).to(torch.float32).expand(b, n)
    py = ((tile_id // n_tx) * th + within // tw).to(torch.float32).expand(b, n)
    if gens is not None:
        jit_xy = uniform(gens, (n, 2), device)
        px = px + jit_xy[..., 0]
        py = py + jit_xy[..., 1]
    else:
        px = px + 0.5
        py = py + 0.5
    o, d = rays_from_ndc(camera, pixel_to_ndc(px, py, width, height))
    return o, d, None


def unpermute_rows(x: Tensor, inv_perm, width: int, height: int,
                   tile: tuple[int, int] = (128, 16)) -> Tensor:
    """Tile-major per-ray results (B, N, ...) -> row-major pixel order
    (`inv_perm` is camera_rays_tiled's third value, always None here)."""
    if inv_perm is not None:
        raise ValueError("only the arithmetic tile-major order is ported")
    tw, th = tile
    b = x.shape[0]
    lead = x.shape[2:]
    y = x.reshape(b, height // th, width // tw, th, tw, *lead).transpose(2, 3)
    return y.reshape(b, width * height, *lead)


def permute_rows(x: Tensor, width: int, height: int,
                 tile: tuple[int, int] = (128, 16)) -> Tensor:
    """Row-major per-pixel values (B, N, ...) -> tile-major order, the
    order of camera_rays_tiled; the inverse of `unpermute_rows` (the
    reference's `_tile_permutation` perm, for films that divide into
    tiles)."""
    tw, th = tile
    if width % tw or height % th:
        raise NotImplementedError(
            f"film {width}x{height} must divide into {tw}x{th} tiles")
    b = x.shape[0]
    lead = x.shape[2:]
    y = x.reshape(b, height // th, th, width // tw, tw, *lead).transpose(2, 3)
    return y.reshape(b, width * height, *lead)


def pixel_to_ndc(px: Tensor, py: Tensor, width: int, height: int) -> Tensor:
    """Continuous pixel coords -> NDC (x right, y up, both [-1, 1])."""
    x = px / width * 2.0 - 1.0
    y = 1.0 - py / height * 2.0
    return torch.stack([x, y], dim=-1)


def ndc_to_pixel(ndc: Tensor, width: int, height: int) -> Tensor:
    """NDC (..., 2+) -> continuous pixel coords (..., 2) as (px, py); the
    inverse of pixel_to_ndc."""
    px = (ndc[..., 0] + 1.0) * 0.5 * width
    py = (1.0 - ndc[..., 1]) * 0.5 * height
    return torch.stack([px, py], dim=-1)


def rays_from_ndc(camera: Camera, ndc: Tensor):
    """NDC points (B, N, 2) -> world-space rays (o, d), each (B, N, 3)."""
    tan_half = torch.tan(torch.deg2rad(camera.fov) / 2.0)[:, None]
    d_local = torch.stack(
        [ndc[..., 0] * tan_half, ndc[..., 1] * tan_half, -torch.ones_like(ndc[..., 0])],
        dim=-1,
    )
    d_world = ffmath.normalize_vectors(ffmath.transform_directions(d_local, camera.to_world))
    o = camera.to_world[:, None, :3, 3].expand_as(d_world)
    return o, d_world


def points_to_ndc(camera: Camera, points: Tensor) -> Tensor:
    """World points (B, N, 3) -> NDC (B, N, 3): x, y in [-1, 1] across the
    field of view, z the view-space depth (positive in front of the
    camera).  Into view space by the inverse pose, then the perspective
    divide (depths below 1e-8 in magnitude divide by 1e-8)."""
    view = ffmath.transform_points(points, torch.linalg.inv(camera.to_world))
    depth = -view[..., 2]
    tan_half = torch.tan(torch.deg2rad(camera.fov) / 2.0)[:, None]
    safe = torch.where(depth.abs() < 1e-8, 1e-8, depth)
    x = view[..., 0] / (safe * tan_half)
    y = view[..., 1] / (safe * tan_half)
    return torch.stack([x, y, depth], dim=-1)
