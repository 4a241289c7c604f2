"""Laser: the structured-light point-pattern projector (port of
fireflies_tpu/projection/laser.py).

Laser-local space looks down -Z (like the camera); the pattern generators
(a grid by angle or by count, uniform random, Poisson-disk) return unit
direction vectors (K, 3).  Two projector routes carry the pattern into
SceneBridge.assemble, both differentiable with respect to the beam
directions: `rays_to_beam_params` gives the analytic beam-splat entries,
`rays_to_texture_rgb` the rasterized (H, W, 3) texture for "tex.data".
The pure ray operations place beams in the world, keep an optimized
pattern inside the projector's field of view (`clamp_rays_to_fov`, and the
respawns, which draw fresh beams from a torch.Generator) and project the
beams' near-far segments into a camera (`epipolar_line_segments`).  The
`Laser` class holds one pattern on the projector's Transformable and
saves and loads it as JSON (which YAML readers load too; `load` also
reads the block YAML the JAX package writes), so no YAML library is
needed.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np
import torch

from fireflies_tpu_torch import sampling
from fireflies_tpu_torch.entity.transformable import Transformable
from fireflies_tpu_torch.graphics import rasterization
from fireflies_tpu_torch.postprocessing import gaussian_blur2d
from fireflies_tpu_torch.projection.camera import (
    Camera,
    directions_to_ndc,
    ndc_to_directions,
    points_to_ndc,
)
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


def generate_uniform_rays_by_count(num_beams_x: int, num_beams_y: int, fov_deg: float,
                                   device="cuda") -> Tensor:
    """Beams through the cell centres of an (nx, ny) grid over the
    projector's NDC square; (nx * ny, 3), x-major."""
    xs = (torch.arange(num_beams_x, dtype=torch.float32, device=device) + 0.5) / num_beams_x
    ys = (torch.arange(num_beams_y, dtype=torch.float32, device=device) + 0.5) / num_beams_y
    gx, gy = torch.meshgrid(xs * 2.0 - 1.0, ys * 2.0 - 1.0, indexing="ij")
    return ndc_to_directions(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1), fov_deg)


def generate_random_rays(gen: Optional[torch.Generator], num_beams: int, fov_deg: float,
                         ndc: Optional[Tensor] = None) -> Tensor:
    """Beams through NDC points uniform in [-1, 1)^2, drawn from `gen` on
    its device (or the given (num_beams, 2) `ndc`)."""
    if ndc is None:
        ndc = torch.rand((num_beams, 2), generator=gen, device=gen.device) * 2.0 - 1.0
    return ndc_to_directions(ndc, fov_deg)


def generate_blue_noise_rays(image_size_x: int, image_size_y: int, num_beams: int,
                             fov_deg: float, seed: Optional[int] = None,
                             radius_type: str = "default", device="cuda") -> Tensor:
    """Poisson-disk pattern: `sampling.bridson` on an (X, Y) pixel grid at
    the constant radius 1.25 sqrt(XY / (pi N)) (seeded on the host), the
    points mapped into NDC, then beams (about num_beams of them)."""
    radius = math.sqrt((image_size_x * image_size_y) / (math.pi * num_beams))
    radius += radius / 4.0
    radius_map = np.full((image_size_y, image_size_x), radius, np.float32)
    _, samples = sampling.bridson(radius_map, seed=seed, radius_type=radius_type)
    yx = torch.as_tensor(samples, dtype=torch.float32, device=device).reshape(-1, 2)
    ndc = torch.stack([yx[:, 1] / image_size_x * 2.0 - 1.0, yx[:, 0] / image_size_y * 2.0 - 1.0],
                      dim=-1)
    return ndc_to_directions(ndc, fov_deg)


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


def epipolar_line_segments(rays_local: Tensor, laser_to_world: Tensor, camera_to_world: Tensor,
                           camera_fov_deg: float, near: float, far: float) -> Tensor:
    """Each beam's points at distances `near` and `far` from the laser,
    projected into the camera's NDC: (K, 2, 2) segments."""
    rays_w = rays_to_world(rays_local, laser_to_world)
    o = origin_per_ray(laser_to_world, rays_local.shape[0])
    p_near = points_to_ndc(o + near * rays_w, camera_to_world, camera_fov_deg)[:, :2]
    p_far = points_to_ndc(o + far * rays_w, camera_to_world, camera_fov_deg)[:, :2]
    return torch.stack([p_near, p_far], dim=1)


def _float_text(x: float) -> str:
    """A float as JSON that YAML 1.1 readers also take as a float: with a
    '.' before any exponent (PyYAML reads 1e-05 as a string)."""
    text = repr(float(x))
    if "e" in text and "." not in text.split("e")[0]:
        text = text.replace("e", ".0e")
    return text


def _parse_laser_file(text: str) -> dict:
    """The fields of a saved laser: JSON, or the block YAML that
    `yaml.safe_dump` writes for this fixed schema (`rays` as a list of
    three-float lists, `fov`, `near_clip`, `far_clip`)."""
    if text.lstrip().startswith("{"):
        return json.loads(text)
    data: dict = {}
    rays: list = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("- - "):  # a new ray's first component
            rays.append([float(line[4:])])
        elif line.startswith("  - "):  # the next component of the ray
            rays[-1].append(float(line[4:]))
        else:
            key, _, value = line.partition(":")
            value = value.strip()
            if key == "rays":
                if value not in ("", "[]"):
                    raise ValueError(f"unreadable rays entry {line!r}")
            else:
                data[key] = float(value)
    data["rays"] = rays
    return data


class Laser(Camera):
    """A beam pattern (K, 3) in the projector's local frame, on the
    projector's Transformable, with the camera's intrinsics; the pattern's
    device is the laser's device."""

    # The generators under the reference's names.
    generate_uniform_rays = staticmethod(generate_uniform_rays)
    generate_uniform_rays_by_count = staticmethod(generate_uniform_rays_by_count)
    generate_random_rays = staticmethod(generate_random_rays)
    generate_blue_noise_rays = staticmethod(generate_blue_noise_rays)

    def __init__(self, transformable: Transformable, ray_directions: Tensor, fov: float = 30.0,
                 near_clip: float = 0.01, far_clip: float = 1000.0):
        rays = torch.as_tensor(ray_directions, dtype=torch.float32)
        super().__init__(transformable, fov, near_clip, far_clip, device=rays.device)
        self._rays = rays

    # -- ray state ------------------------------------------------------------------

    def local_rays(self) -> Tensor:
        return self._rays

    def set_rays(self, rays: Tensor) -> None:
        self._rays = torch.as_tensor(rays, dtype=torch.float32, device=self._device)

    def rays(self, params: Optional[dict] = None) -> Tensor:
        """World-space unit beam directions (K, 3)."""
        return rays_to_world(self._rays, self.world(params))

    def origin_per_ray(self, params: Optional[dict] = None) -> Tensor:
        return origin_per_ray(self.world(params), self._rays.shape[0])

    originPerRay = origin_per_ray

    def normalize_rays(self) -> None:
        self._rays = ffmath.normalize_vectors(self._rays)

    # -- NDC round trips --------------------------------------------------------------

    def project_rays_to_ndc(self) -> Tensor:
        return directions_to_ndc(self._rays, self._fov)

    projectRaysToNDC = project_rays_to_ndc

    def project_ndc_points_to_rays(self, ndc: Tensor) -> Tensor:
        return ndc_to_directions(ndc, self._fov)

    projectNDCPointsToWorld = project_ndc_points_to_rays

    def clamp_to_fov(self, clamp_val: float = 0.95) -> None:
        self._rays = clamp_rays_to_fov(self._rays, self._fov, clamp_val)

    def randomize_laser_out_of_bounds(self, gen: torch.Generator) -> None:
        self._rays = respawn_out_of_bounds(gen, self._rays, self._fov)

    def randomize_camera_out_of_bounds(self, gen: torch.Generator, camera_ndc: Tensor) -> None:
        self._rays = respawn_out_of_camera(gen, self._rays, camera_ndc, self._fov)

    # -- textures and epipolar lines ----------------------------------------------------

    def generate_texture(self, sigma: float, texture_size) -> Tensor:
        return rays_to_texture(self._rays, self._fov, sigma, texture_size)

    generateTexture = generate_texture

    def generate_texture_summed(self, sigma: float, texture_size) -> Tensor:
        return rays_to_texture_summed(self._rays, self._fov, sigma, texture_size)

    def generate_texture_rgb(self, sigma: float, texture_size, **kw) -> Tensor:
        return rays_to_texture_rgb(self._rays, self._fov, sigma, texture_size, **kw)

    def render_epipolar_lines(self, camera: Camera, sigma: float, texture_size,
                              params: Optional[dict] = None) -> Tensor:
        """(K, H, W) line splats of each beam's near-far segment as
        `camera` sees it (`rasterization.rasterize_lines`, y down)."""
        segs_ndc = epipolar_line_segments(self._rays, self.world(params), camera.world(params),
                                          camera.fov(), self._near_clip, self._far_clip)
        flip = torch.tensor([1.0, -1.0], device=segs_ndc.device)
        return rasterization.rasterize_lines((segs_ndc * flip + 1.0) * 0.5, sigma, texture_size)

    # -- persistence ---------------------------------------------------------------------

    def save(self, filepath: str) -> None:
        """Write `rays`, `fov`, `near_clip` and `far_clip` as JSON."""
        rays = ",\n  ".join("[" + ", ".join(_float_text(x) for x in ray) + "]"
                            for ray in self._rays.detach().cpu().tolist())
        with open(filepath, "w") as f:
            f.write(f'{{"rays": [\n  {rays}\n], "fov": {_float_text(self._fov)}, '
                    f'"near_clip": {_float_text(self._near_clip)}, '
                    f'"far_clip": {_float_text(self._far_clip)}}}\n')

    @classmethod
    def load(cls, filepath: str, transformable: Transformable, device="cuda") -> "Laser":
        """A laser saved by either package (JSON or the JAX package's YAML)
        on `transformable`, its rays on `device`."""
        with open(filepath) as f:
            data = _parse_laser_file(f.read())
        rays = torch.tensor(data["rays"], dtype=torch.float32, device=device).reshape(-1, 3)
        return cls(transformable, rays, fov=float(data["fov"]),
                   near_clip=float(data["near_clip"]), far_clip=float(data["far_clip"]))
