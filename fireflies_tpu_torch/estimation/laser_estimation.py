"""Laser pattern initialization: RANDOM / POISSON / GRID / SMARTY (port of
fireflies_tpu/estimation/laser_estimation.py).

  * probability_distribution_from_depth_maps: the per-pixel (population)
    standard deviation over randomized depth maps, plus a uniform weight;
  * points_from_probability_distribution: sampling without replacement
    by Gumbel top-k;
  * generate_epipolar_constraints: the projector frustum's far corners
    projected into the camera, their convex hull filled into a mask;
  * laser_from_ndc_points: camera rays through chosen pixels meet the
    mean-depth plane; the laser is re-aimed at those points;
  * initialize_laser: the four-mode dispatcher.  SMARTY renders the depth
    maps of randomized variants in one batch (render_depth, the camera's
    shared-origin closest hit), turns their variance into a radius map,
    draws variable-radius blue noise over it on the host (Bridson) and
    re-aims the chosen pixels from the projector.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fireflies_tpu_torch import sampling
from fireflies_tpu_torch.projection import laser as laser_mod
from fireflies_tpu_torch.projection.laser import Laser
from fireflies_tpu_torch.render import integrators
from fireflies_tpu_torch.render.rays import points_to_ndc, rays_from_ndc
from fireflies_tpu_torch.render.types import Camera as RenderCamera
from fireflies_tpu_torch.render.types import RenderConfig, RenderScene
from fireflies_tpu_torch.utils import intersections
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor


@dataclasses.dataclass
class LaserConfig:
    """Pattern-initialization settings."""

    n_beams: int = 150
    n_depthmaps: int = 16
    variational_epsilon: float = 1e-3
    smarty_min_radius: float = 4.0
    smarty_max_radius: float = 32.0
    image_size: tuple[int, int] = (256, 256)  # (W, H) of the sampling map
    save_images: bool = False
    save_dir: str = "."


def probability_distribution_from_depth_maps(depth_maps: Tensor,
                                             uniform_weight: float = 0.0) -> Tensor:
    """(N, H, W) depth maps -> (H, W) population standard deviation plus a
    uniform floor."""
    return torch.std(depth_maps, dim=0, correction=0) + uniform_weight


def points_from_probability_distribution(prob: Tensor, num_samples: int,
                                         gen: Optional[torch.Generator] = None,
                                         gumbel: Optional[Tensor] = None) -> Tensor:
    """`num_samples` flat indices drawn without replacement with
    probability proportional to `prob`: the top k of log p + Gumbel noise,
    the noise drawn from `gen` on its device (or given, `gumbel`, one per
    pixel)."""
    logp = torch.log(prob.reshape(-1).clamp_min(1e-20))
    if gumbel is None:
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(logp.shape, generator=gen, device=gen.device).clamp_min(tiny)
        gumbel = -torch.log(-torch.log(u))
    return torch.topk(logp + gumbel.reshape(-1).to(logp.device), num_samples).indices


# ---------------------------------------------------------------------------
# Epipolar constraints
# ---------------------------------------------------------------------------


def _convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull (host side; a handful of points),
    counter-clockwise in a y-up frame."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) <= 2:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def fill_convex_polygon(vertices_px: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """(H, W) float32 mask of the pixel indices left of (or on) every edge of
    a convex polygon (CCW in a y-up frame)."""
    h, w = size_hw
    gy, gx = np.mgrid[0:h, 0:w]
    mask = np.ones((h, w), bool)
    n = len(vertices_px)
    for i in range(n):
        x0, y0 = vertices_px[i]
        x1, y1 = vertices_px[(i + 1) % n]
        mask &= (x1 - x0) * (gy - y0) - (y1 - y0) * (gx - x0) >= 0
    return mask.astype(np.float32)


def _first_variant(camera: RenderCamera) -> RenderCamera:
    return RenderCamera(to_world=camera.to_world[:1], fov=camera.fov[:1], near=camera.near[:1],
                        far=camera.far[:1])


def generate_epipolar_constraints(camera: RenderCamera, projector_to_world: Tensor,
                                  projector_fov_deg: float, projector_far: float,
                                  image_size_hw: tuple[int, int]) -> np.ndarray:
    """(H, W) binary float32 mask of the camera pixels (variant 0 of
    `camera`) that some projector beam can reach: the frustum's far corners
    projected into the camera, their hull filled (all ones when the hull
    is degenerate)."""
    corners_ndc = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]],
                               device=projector_to_world.device)
    dirs_w = laser_mod.rays_to_world(laser_mod.ndc_to_directions(corners_ndc, projector_fov_deg),
                                     projector_to_world)
    far_points = projector_to_world[:3, 3] + projector_far * dirs_w
    ndc = points_to_ndc(_first_variant(camera), far_points[None])[0].cpu().numpy()
    h, w = image_size_hw
    px = (ndc[:, 0] + 1.0) * 0.5 * w
    py = (1.0 - ndc[:, 1]) * 0.5 * h
    hull = _convex_hull_2d(np.stack([px, py], axis=-1))
    if len(hull) < 3:
        return np.ones((h, w), np.float32)
    return fill_convex_polygon(hull, (h, w))


# ---------------------------------------------------------------------------
# Beams from chosen camera pixels
# ---------------------------------------------------------------------------


def laser_from_ndc_points(camera: RenderCamera, laser_origin: Tensor, mean_depth: Tensor,
                          chosen_points: Tensor, image_size_hw: tuple[int, int]) -> Tensor:
    """World-space unit beams (K, 3) from `laser_origin` at the scene
    points the chosen pixels (flat indices into (H, W)) of the camera's
    variant 0 see, taking the scene as the plane at `mean_depth` in front
    of the camera."""
    h, w = image_size_hw
    py = (chosen_points // w).to(torch.float32) + 0.5
    px = (chosen_points % w).to(torch.float32) + 0.5
    ndc = torch.stack([px / w * 2.0 - 1.0, 1.0 - py / h * 2.0], dim=-1)
    camera = _first_variant(camera)
    o, d = rays_from_ndc(camera, ndc[None])
    pose = camera.to_world[0]
    cam_fwd = -pose[:3, 2]
    plane_origin = pose[:3, 3] + cam_fwd * mean_depth
    world_points = intersections.ray_plane(o[0], d[0], plane_origin, -cam_fwd)
    return ffmath.normalize_vectors(world_points - laser_origin)


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------


def initialize_laser(scene, bridge, config: LaserConfig, mode: str = "GRID",
                     gen: Optional[torch.Generator] = None, projector_fov: float = 30.0,
                     render_config: Optional[RenderConfig] = None, device="cuda",
                     variants: Optional[tuple[RenderScene, RenderScene]] = None,
                     info: Optional[dict] = None) -> Laser:
    """A Laser on `scene`'s projector with an initial pattern, its beams
    on `device` (the card unless the caller asks for the CPU).

    Args:
      scene: a Scene with a projector (and a camera for SMARTY).
      bridge: its SceneBridge (SMARTY renders depth maps through it).
      config: LaserConfig.
      mode: "RANDOM" (config.n_beams uniform NDC points from `gen`),
        "POISSON" (Poisson-disk over config.image_size, `sampling.bridson`
        seeded 0),
        "GRID" (floor(sqrt(n_beams))^2 cell centres) or "SMARTY".
      gen: torch.Generator on `device` for RANDOM's points and SMARTY's
        variants (default: seeded 0).
      projector_fov: the laser's fov in degrees.
      render_config: SMARTY's depth-map film (default: config.image_size,
        spp 1, one bounce), of any size.
      variants: SMARTY's (depth-map scene of n_depthmaps variants,
        one-variant reference scene) in place of drawing them: by default
        variant i of the depth maps is randomized at step i from a
        generator seeded from `gen` (`integrators.random_depth_maps`, one
        batched render), the reference at step 0 from a generator seeded 0.
      info: filled by SMARTY with its intermediate maps, Bridson's points
        ("points", (n, 2) float64 (y, x) on the film) and the seconds of
        its parts: "depth_maps_s" (the variants and their render, to the
        device's end), "bridson_s" (host) and "total_s".
    """
    if scene.projector() is None:
        raise ValueError("scene has no projector")
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    w, h = config.image_size

    if mode == "RANDOM":
        rays = laser_mod.generate_random_rays(gen, config.n_beams, projector_fov)
    elif mode == "POISSON":
        rays = laser_mod.generate_blue_noise_rays(w, h, config.n_beams, projector_fov, seed=0,
                                                  device=device)
    elif mode == "GRID":
        grid_width = int(math.sqrt(config.n_beams))
        rays = laser_mod.generate_uniform_rays_by_count(grid_width, grid_width, projector_fov,
                                                        device=device)
    elif mode == "SMARTY":
        rays = _initialize_smarty(scene, bridge, config, gen, projector_fov, render_config,
                                  device, variants, info if info is not None else {})
    else:
        raise ValueError(f"unknown laser init mode {mode!r}")
    return Laser(scene.projector(), rays, fov=projector_fov)


def _initialize_smarty(scene, bridge, config: LaserConfig, gen, projector_fov: float,
                       render_config, device, variants, info: dict) -> Tensor:
    t0 = time.perf_counter()
    w, h = config.image_size
    render_config = render_config or RenderConfig(width=w, height=h, spp=1, max_bounces=1)
    if variants is None:
        randomize = scene.compile(device=device)

        def randomize_fn(gens, steps):
            return bridge.assemble([randomize(g, s) for g, s in zip(gens, steps)])

        # Variant i at step i, each from a generator seeded from `gen`; the
        # reference variant from a generator seeded 0 at step 0.
        seeds = torch.randint(0, 2**62, (config.n_depthmaps,), generator=gen,
                              device=gen.device).tolist()
        depth_maps = integrators.random_depth_maps(
            randomize_fn, [torch.Generator(device=device).manual_seed(s) for s in seeds],
            render_config)
        ref_scene = randomize_fn([torch.Generator(device=device).manual_seed(0)], [0])
    else:
        maps_scene, ref_scene = variants
        depth_maps = integrators.render_depth(maps_scene, render_config)
    if depth_maps.is_cuda:
        torch.cuda.synchronize(depth_maps.device)
    t_maps = time.perf_counter()

    variance_map = ffmath.normalize(
        probability_distribution_from_depth_maps(depth_maps, config.variational_epsilon))

    # Only the pixels some beam can reach.
    laser_world = torch.as_tensor(scene.projector().non_randomized_world(), dtype=torch.float32,
                                  device=depth_maps.device)
    constraint = generate_epipolar_constraints(ref_scene.camera, laser_world, projector_fov,
                                               1000.0, (render_config.height, render_config.width))
    sampling_map = variance_map * torch.as_tensor(constraint, device=depth_maps.device)
    total = sampling_map.sum()
    sampling_map = sampling_map / torch.where(total == 0, 1.0, total)

    # High variance -> small radius -> dense beams.
    inv = 1.0 - ffmath.normalize(sampling_map)
    radius_map = config.smarty_min_radius + (
        config.smarty_max_radius - config.smarty_min_radius) * inv
    radius_np = radius_map.cpu().numpy()
    t1 = time.perf_counter()
    _, points = sampling.bridson(radius_np, k=50, seed=0)
    t_bridson = time.perf_counter() - t1
    pts = np.floor(points).astype(np.int64)
    pts[:, 0] = np.clip(pts[:, 0], 0, render_config.height - 1)
    pts[:, 1] = np.clip(pts[:, 1], 0, render_config.width - 1)
    pts = pts[constraint[pts[:, 0], pts[:, 1]] > 0]
    chosen_np = pts[:, 0] * render_config.width + pts[:, 1]
    chosen = torch.as_tensor(chosen_np, device=depth_maps.device)

    if config.save_images:
        # Debug images: the inferno variance map with the chosen pixels
        # inverted, and the constraint mask.
        from fireflies_tpu_torch.utils.colormap import inferno  # noqa: PLC0415
        from fireflies_tpu_torch.utils.png import write_png  # noqa: PLC0415

        flat = inferno(variance_map.cpu().numpy())
        rgb = flat.reshape(-1, 3)
        rgb[chosen_np] = 1.0 - rgb[chosen_np]
        write_png(str(Path(config.save_dir) / "sampling_map.png"), flat)
        write_png(str(Path(config.save_dir) / "constraint_map.png"), constraint)

    # The reference package's mean: any miss (depth 0) makes it NaN, and a
    # NaN mean becomes 1.0.
    mean_depth = torch.nan_to_num(torch.where(depth_maps > 0, depth_maps, torch.nan).mean(),
                                  nan=1.0)
    laser_dir_world = laser_from_ndc_points(ref_scene.camera, laser_world[:3, 3], mean_depth,
                                            chosen, (render_config.height, render_config.width))
    # Into the projector's local frame.
    local_dir = ffmath.transform_directions(laser_dir_world, torch.linalg.inv(laser_world))
    rays = ffmath.normalize_vectors(local_dir)
    info.update(depth_maps=depth_maps, variance_map=variance_map, constraint=constraint,
                radius_map=radius_map, points=points, chosen=chosen, mean_depth=mean_depth,
                camera=ref_scene.camera, laser_world=laser_world,
                depth_maps_s=t_maps - t0, bridson_s=t_bridson, total_s=time.perf_counter() - t0)
    return rays
