"""Camera ray generation (port of fireflies_tpu/render/rays.py).

Camera space looks down -Z, +Y up, x-fov in degrees with square pixels;
pixel (0, 0) is the top-left of the image.  Only the tile-major route is
ported: the film must divide into 128x16-pixel tiles, so the pixel order is
computed arithmetically and undone with a reshape.
"""

from __future__ import annotations

import torch

from fireflies_tpu_torch.render.types import Camera
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor


def uniform(gens, shape, device) -> Tensor:
    """(B, *shape) U[0, 1) draws, one generator per variant."""
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


def pixel_to_ndc(px: Tensor, py: Tensor, width: int, height: int) -> Tensor:
    """Continuous pixel coords -> NDC (x right, y up, both [-1, 1])."""
    x = px / width * 2.0 - 1.0
    y = 1.0 - py / height * 2.0
    return torch.stack([x, y], dim=-1)


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
