"""AOV integrators: depth, segmentation, laser-dot depth (port of
fireflies_tpu/render/integrators.py).

Every function takes a batched RenderScene (leading variant axis B) and
returns one map per variant:

  * render_depth: primary-visibility distance along the unit camera ray, 0
    on a miss;
  * render_depth_differentiable: the same depth with gradients with respect
    to the vertices (detached traversal, t re-derived on the hit face);
  * render_segmentation / render_shape_index: per-pixel mesh id + 1, 0 on
    the background;
  * render_from_laser: laser rays cast into the scene, their hits projected
    into the camera and splatted into a sparse depth image;
  * random_depth_maps: the depth maps of randomized variants.

Camera rays start at the camera (shared origin, B1 or B2 by face count);
laser rays go through the per-ray-origin route (B3, B5 or B4).
"""

from __future__ import annotations

from typing import Callable

import torch

from fireflies_tpu_torch.render.intersect import closest_hit, hit_attributes
from fireflies_tpu_torch.render.rays import (
    camera_rays_tiled,
    ndc_to_pixel,
    points_to_ndc,
    unpermute_rows,
)
from fireflies_tpu_torch.render.types import RenderConfig, RenderScene

Tensor = torch.Tensor


def _camera_hit(scene: RenderScene, config: RenderConfig, gens=None):
    """(o, d, inv_perm, hit) of the camera rays, tile-major; `gens` jitter
    them inside their pixels."""
    o, d, inv_perm = camera_rays_tiled(scene.camera, config.width, config.height, gens)
    hit = closest_hit(o, d, scene.geometry, tri_chunk=config.tri_chunk, backend=config.backend,
                      shared_origin=scene.camera.to_world[:, :3, 3], tile_cull=config.tile_cull)
    return o, d, inv_perm, hit


def _film(x: Tensor, inv_perm, config: RenderConfig) -> Tensor:
    """Tile-major per-ray values (B, N) -> images (B, H, W)."""
    rows = unpermute_rows(x, inv_perm, config.width, config.height)
    return rows.reshape(x.shape[0], config.height, config.width)


def render_depth(scene: RenderScene, config: RenderConfig, gens=None) -> Tensor:
    """(B, H, W) primary-visibility depth (distance along the unit ray); 0
    on a miss."""
    _, _, inv_perm, hit = _camera_hit(scene, config, gens)
    return _film(torch.where(hit.valid, hit.t, 0.0), inv_perm, config)


def render_depth_differentiable(scene: RenderScene, config: RenderConfig, gens=None) -> Tensor:
    """render_depth with gradients with respect to the vertices: the
    traversal is detached and t re-derived on the hit face."""
    o, d, inv_perm, hit = _camera_hit(scene, config, gens)
    t = hit_attributes(o, d, hit, scene.geometry)["t"]
    return _film(torch.where(hit.valid, t, 0.0), inv_perm, config)


def render_segmentation(scene: RenderScene, config: RenderConfig) -> Tensor:
    """(B, H, W) int32 mesh-id maps: 0 = background, mesh ids start at 1."""
    _, _, inv_perm, hit = _camera_hit(scene, config)
    mesh_id = scene.geometry.face_mesh[hit.prim.clamp(min=0).long()] + 1
    seg = torch.where(hit.valid, mesh_id, 0)
    return _film(seg, inv_perm, config).to(torch.int32)


def render_shape_index(scene: RenderScene, config: RenderConfig) -> Tensor:
    """Alias of render_segmentation under the reference's name."""
    return render_segmentation(scene, config)


def render_from_laser(scene: RenderScene, laser_origins: Tensor, laser_dirs: Tensor,
                      config: RenderConfig, sigma: float = 1.0):
    """Sparse structured-light depth: cast the laser rays (B, K, 3), project
    their hits into the camera; returns (points_ndc (B, K, 3), depth
    (B, K), valid (B, K), image (B, H, W)).

    `image` is the per-pixel maximum over the valid beams of the camera-space
    depth times a Gaussian footprint of std `sigma` pixels (differentiable).
    """
    hit = closest_hit(laser_origins, laser_dirs, scene.geometry, tri_chunk=config.tri_chunk,
                      backend=config.backend, tile_cull=config.tile_cull)
    p = hit_attributes(laser_origins, laser_dirs, hit, scene.geometry)["position"]
    ndc = points_to_ndc(scene.camera, p)
    in_view = (ndc[..., 0].abs() <= 1.0) & (ndc[..., 1].abs() <= 1.0) & (ndc[..., 2] > 0)
    valid = hit.valid & in_view

    pix = ndc_to_pixel(ndc, config.width, config.height)
    gy, gx = torch.meshgrid(torch.arange(config.height, dtype=torch.float32, device=p.device),
                            torch.arange(config.width, dtype=torch.float32, device=p.device),
                            indexing="ij")
    dx = gx - pix[..., 0, None, None]  # (B, K, H, W)
    dy = gy - pix[..., 1, None, None]
    w = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    w = torch.where(valid[..., None, None], w, 0.0)
    image = (w * ndc[..., 2, None, None]).amax(dim=1)
    return ndc, ndc[..., 2], valid, image


def random_depth_maps(randomize_fn: Callable[[list, list], RenderScene], gens,
                      config: RenderConfig) -> Tensor:
    """(n, H, W) depth maps of n randomized variants, one per generator,
    at steps 0 .. n-1: `randomize_fn(gens, steps) -> RenderScene` with
    one variant per generator, rendered in one batch."""
    return render_depth(randomize_fn(gens, list(range(len(gens)))), config)
