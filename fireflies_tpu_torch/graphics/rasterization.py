"""Differentiable 2D point and line rasterization (port of
fireflies_tpu/graphics/rasterization.py).

Per-point Gaussian splats g = exp(-((d^2)/sigma)^2) over the whole image,
points in [0, 1]^2 (u right, v down) or in pixels
(`rasterize_points_in_non_ndc`), sigma in squared-pixel units; depth-scaled
splats; line segments as the distance transform exp(-(d^2)^2 / sigma^2).
`sum_points` and `softor_points` reduce over the points chunk by chunk, so
no (N, H, W) stack is held, with the same result as reducing the stack;
`subsampled_point_raster` is their pyramid.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _grid(texture_size, device=None) -> tuple[Tensor, Tensor]:
    """Pixel-index coordinate grids (gx, gy), each (H, W): gx varies along
    the width, gy along the height."""
    h, w = int(texture_size[0]), int(texture_size[1])
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return gx, gy


def _point_gaussians(points_px: Tensor, gx: Tensor, gy: Tensor, sigma: float) -> Tensor:
    """(N, H, W) Gaussian splats around pixel-space points (N, 2)."""
    dx = gx[None] - points_px[:, 0, None, None]
    dy = gy[None] - points_px[:, 1, None, None]
    d2 = dx * dx + dy * dy
    return torch.exp(-torch.square(d2 / sigma))


def _to_px(points: Tensor, h: int, w: int) -> Tensor:
    return points * torch.tensor([w, h], dtype=torch.float32, device=points.device)


def rasterize_points(points: Tensor, sigma: float, texture_size) -> Tensor:
    """Points (N, 2) in [0, 1]^2 -> (N, H, W) splat stack."""
    h, w = int(texture_size[0]), int(texture_size[1])
    gx, gy = _grid((h, w), points.device)
    return _point_gaussians(_to_px(points, h, w), gx, gy, sigma)


def rasterize_points_in_non_ndc(points: Tensor, sigma: float, texture_size) -> Tensor:
    """Points (N, 2) already in pixels -> (N, H, W) splat stack."""
    gx, gy = _grid(texture_size, points.device)
    return _point_gaussians(points, gx, gy, sigma)


def rasterize_depth(points: Tensor, depth_vals: Tensor, sigma: float, texture_size) -> Tensor:
    """(N, H, W) splats, each divided by its own peak (where nonzero) and
    scaled by its point's depth value (N,)."""
    splats = rasterize_points(points, sigma, texture_size)
    peak = splats.amax(dim=(1, 2), keepdim=True)
    splats = splats / torch.where(peak == 0, 1.0, peak)
    return splats * depth_vals[:, None, None]


def rasterize_lines(lines: Tensor, sigma: float, texture_size) -> Tensor:
    """Line segments (N, 2, 2) in [0, 1]^2 -> (N, H, W) distance-transform
    splats exp(-(d^2)^2 / sigma^2), d the pixel's distance to the segment."""
    h, w = int(texture_size[0]), int(texture_size[1])
    a = _to_px(lines[:, 0, :], h, w)
    b = _to_px(lines[:, 1, :], h, w)
    gx, gy = _grid((h, w), lines.device)
    ax, ay = a[:, 0, None, None], a[:, 1, None, None]
    mx, my = b[:, 0, None, None] - ax, b[:, 1, None, None] - ay
    pax, pay = gx[None] - ax, gy[None] - ay
    mm = mx * mx + my * my
    t0 = ((pax * mx + pay * my) / (mm + 1e-12)).clamp(0.0, 1.0)
    dx = pax - t0 * mx
    dy = pay - t0 * my
    d2 = dx * dx + dy * dy
    return torch.exp(-(d2 * d2) / (sigma * sigma))


def softor(texture: Tensor, axis: int = 0, keepdims: bool = False) -> Tensor:
    """Differentiable union 1 - prod(1 - x)."""
    return 1.0 - torch.prod(1.0 - texture, dim=axis, keepdim=keepdims)


def sum_(texture: Tensor, axis: int = 0, keepdims: bool = False) -> Tensor:
    return texture.sum(dim=axis, keepdim=keepdims)


# The reference's export name (it shadows builtins.sum there too).
sum = sum_  # noqa: A001


def _chunked_reduce(points: Tensor, sigma: float, texture_size, chunk: int, mode: str) -> Tensor:
    """(H, W) sum ("sum") or soft union (otherwise) of the points' splats,
    `chunk` points at a time.  The last chunk is padded with far points,
    whose splats are exp(-huge) = 0."""
    h, w = int(texture_size[0]), int(texture_size[1])
    n = points.shape[0]
    chunk = max(min(chunk, n), 1)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    pts_px = _to_px(points, h, w)
    if pad:
        pts_px = torch.cat([pts_px, torch.full((pad, 2), -1e6, device=points.device)])
    gx, gy = _grid((h, w), points.device)
    if mode == "sum":
        acc = torch.zeros((h, w), device=points.device)
        for pts in pts_px.reshape(n_chunks, chunk, 2):
            acc = acc + _point_gaussians(pts, gx, gy, sigma).sum(dim=0)
        return acc
    acc = torch.ones((h, w), device=points.device)
    for pts in pts_px.reshape(n_chunks, chunk, 2):
        acc = acc * torch.prod(1.0 - _point_gaussians(pts, gx, gy, sigma), dim=0)
    return 1.0 - acc


def sum_points(points: Tensor, sigma: float, texture_size, chunk: int = 64) -> Tensor:
    """(H, W) sum over the N splats, without the (N, H, W) stack."""
    return _chunked_reduce(points, sigma, texture_size, chunk, "sum")


def softor_points(points: Tensor, sigma: float, texture_size, chunk: int = 64) -> Tensor:
    """(H, W) soft union over the N splats, without the (N, H, W) stack."""
    return _chunked_reduce(points, sigma, texture_size, chunk, "softor")


def subsampled_point_raster(points: Tensor, n_subsamples: int, sigma: float,
                            texture_size) -> list[Tensor]:
    """Pyramid of soft-union rasters: level k at (H >> k, W >> k), sigma
    divided by 4^k (d^2 shrinks fourfold a halving); a list of (Hk, Wk)."""
    h, w = int(texture_size[0]), int(texture_size[1])
    return [softor_points(points, sigma / (4.0**k), (max(h >> k, 1), max(w >> k, 1)))
            for k in range(n_subsamples)]
