"""Camera ray generation and projection (port of fireflies_tpu/render/rays.py).

Camera space looks down -Z, +Y up, x-fov in degrees with square pixels;
pixel (0, 0) is the top-left of the image.  `camera_rays` gives row-major
rays; `camera_rays_tiled` the tile-major order the kernels prune on, worked
out arithmetically where the film divides into 128x16-pixel tiles (undone
by a reshape) and by a cached permutation otherwise (undone by a gather);
`permute_rows` takes row-major results to that order (what the warped-area
pass needs).  Both ray functions render a horizontal band of a taller film
through `y_offset` / `full_height`.
"""

from __future__ import annotations

import functools

import numpy as np
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


def camera_rays(camera: Camera, width: int, height: int, gens=None, y_offset: int = 0,
                full_height: int | None = None):
    """Primary rays in row-major pixel order; returns (o, d), each (B, H*W, 3).

    With `gens` (one torch.Generator per variant) pixel positions are
    jittered uniformly inside each pixel, the (H*W, 2) draws taken in
    row-major order; otherwise rays pass through pixel centres.
    `y_offset` / `full_height` render a horizontal band: `height` rows
    starting at pixel row `y_offset` of a `full_height`-row film, with the
    whole film's NDC mapping.
    """
    device = camera.to_world.device
    b = camera.to_world.shape[0]
    n = width * height
    py, px = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                            torch.arange(width, dtype=torch.float32, device=device),
                            indexing="ij")
    px, py = px.reshape(1, n).expand(b, n), py.reshape(1, n).expand(b, n)
    return _rays_at(camera, px, py, width, height, gens, y_offset, full_height)


def _rays_at(camera: Camera, px: Tensor, py: Tensor, width: int, height: int, gens,
             y_offset: int, full_height: int | None):
    """Rays through the pixels (px, py) (B, N), jittered by `gens` (one
    (N, 2) draw a variant, in the order of the pixels) or at their centres,
    moved down `y_offset` rows of a `full_height`-row film."""
    if gens is not None:
        jit_xy = uniform(gens, (px.shape[1], 2), px.device)
        px = px + jit_xy[..., 0]
        py = py + jit_xy[..., 1]
    else:
        px = px + 0.5
        py = py + 0.5
    if y_offset:
        py = py + float(y_offset)
    return rays_from_ndc(camera, pixel_to_ndc(px, py, width, full_height or height))


@functools.lru_cache(maxsize=32)
def _tile_permutation(width: int, height: int, tile_w: int, tile_h: int):
    """(perm, inv_perm): host int64 arrays between row-major pixel order and
    the order of (tile_w x tile_h)-pixel blocks, row-major inside a block
    (the blocks at the film's right and bottom edges are partial), cached
    as host arrays (`_tile_perm` keeps their device copies)."""
    ys, xs = np.mgrid[0:height, 0:width]
    tile_idx = (ys // tile_h) * (-(-width // tile_w)) + (xs // tile_w)
    within = (ys % tile_h) * tile_w + (xs % tile_w)
    key = tile_idx.astype(np.int64) * (tile_w * tile_h) + within
    perm = np.argsort(key.reshape(-1), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return perm, inv


@functools.lru_cache(maxsize=32)
def _tile_perm(width: int, height: int, device, tile: tuple[int, int] = (128, 16)):
    """(perm, inv_perm) of `_tile_permutation` as index tensors on `device`,
    uploaded once a film and device; None for a film that divides into
    tiles (a reshape orders it)."""
    tw, th = tile
    if width % tw == 0 and height % th == 0:
        return None
    perm, inv = _tile_permutation(width, height, tw, th)
    return torch.as_tensor(perm, device=device), torch.as_tensor(inv, device=device)


def camera_rays_tiled(
    camera: Camera,
    width: int,
    height: int,
    gens=None,
    tile: tuple[int, int] = (128, 16),
    y_offset: int = 0,
    full_height: int | None = None,
):
    """Primary rays in tile-major order; returns (o, d, inv_perm), o and d
    (B, N, 3).

    Consecutive 2048-ray kernel tiles are 128x16-pixel blocks, so a tile's
    directions form a narrow cone (what the culled kernels prune on).  With
    `gens` (one torch.Generator per variant) pixel positions are jittered
    uniformly inside each pixel; otherwise rays pass through pixel centres.
    A film that divides into tiles computes its pixels in tile-major order
    arithmetically (the jitter drawn in that order) and returns inv_perm
    None: `unpermute_rows` undoes the order with a reshape.  Any other film
    takes `camera_rays` (jitter drawn in row-major order) and gathers it
    into block order (`_tile_permutation`, partial blocks at the edges);
    inv_perm is then the (N,) index tensor that `unpermute_rows` gathers
    with.  `y_offset` / `full_height`: a band of a taller film, as in
    `camera_rays`.
    """
    tw, th = tile
    device = camera.to_world.device
    perms = _tile_perm(width, height, device, tile)
    if perms is not None:
        perm, inv = perms
        o, d = camera_rays(camera, width, height, gens, y_offset, full_height)
        return o[:, perm], d[:, perm], inv
    b = camera.to_world.shape[0]
    n = width * height
    n_tx = width // tw
    i = torch.arange(n, dtype=torch.int32, device=device)
    tile_id = i // (tw * th)
    within = i % (tw * th)
    px = ((tile_id % n_tx) * tw + within % tw).to(torch.float32).expand(b, n)
    py = ((tile_id // n_tx) * th + within // tw).to(torch.float32).expand(b, n)
    o, d = _rays_at(camera, px, py, width, height, gens, y_offset, full_height)
    return o, d, None


def unpermute_rows(x: Tensor, inv_perm, width: int, height: int,
                   tile: tuple[int, int] = (128, 16)) -> Tensor:
    """Tile-major per-ray results (B, N, ...) -> row-major pixel order:
    a reshape where `inv_perm` (camera_rays_tiled's third value) is None,
    else a gather with it."""
    if inv_perm is not None:
        return x[:, inv_perm]
    tw, th = tile
    b = x.shape[0]
    lead = x.shape[2:]
    y = x.reshape(b, height // th, width // tw, th, tw, *lead).transpose(2, 3)
    return y.reshape(b, width * height, *lead)


def permute_rows(x: Tensor, width: int, height: int,
                 tile: tuple[int, int] = (128, 16)) -> Tensor:
    """Row-major per-pixel values (B, N, ...) -> tile-major order, the
    order of camera_rays_tiled; the inverse of `unpermute_rows` (a reshape
    for a film that divides into tiles, else a gather with `_tile_perm`'s
    perm)."""
    perms = _tile_perm(width, height, x.device, tile)
    if perms is not None:
        return x[:, perms[0]]
    tw, th = tile
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
