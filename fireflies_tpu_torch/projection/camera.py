"""Projective camera model shared by the sensor and the laser (port of
fireflies_tpu/projection/camera.py).

A `Camera` wraps a Transformable (the pose) and intrinsics (x-fov in
degrees, clips).  Its methods take an optional randomized param dict (the
output of `Scene.compile()`'s randomize): where it holds
"<name>.to_world", that pose is used, else the entity's unrandomized world
on the camera's device.  The pure functions below (world points to NDC,
directions to NDC and back) carry the work.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fireflies_tpu_torch.entity.transformable import Transformable
from fireflies_tpu_torch.utils import math as ffmath
from fireflies_tpu_torch.utils.io import build_projection_matrix

Tensor = torch.Tensor


class Camera:
    MITSUBA_KEYS = {"fov": "x_fov", "f": "x_fov", "to_world": "to_world", "world": "to_world"}
    # Cameras built in this process, for the keys (as the reference counts).
    _id_counter = 0

    def __init__(self, transformable: Transformable, fov: float = 45.0, near_clip: float = 0.01,
                 far_clip: float = 1000.0, device="cuda"):
        self._transformable = transformable
        self._fov = float(fov)
        self._near_clip = float(near_clip)
        self._far_clip = float(far_clip)
        self._device = torch.device(device)
        self._perspective = build_projection_matrix(fov, near_clip, far_clip)
        self._key = self._generate_key()
        Camera._id_counter += 1

    def _generate_key(self) -> str:
        if Camera._id_counter == 0:
            return "PerspectiveCamera"
        return f"PerspectiveCamera_{Camera._id_counter}"

    # -- accessors ---------------------------------------------------------------

    def key(self) -> str:
        return self._key

    def full_key(self, key: str) -> str:
        return self._key + "." + self.MITSUBA_KEYS[key]

    def fov(self) -> float:
        return self._fov

    def near_clip(self) -> float:
        return self._near_clip

    def far_clip(self) -> float:
        return self._far_clip

    def perspective(self) -> np.ndarray:
        return self._perspective

    def transformable(self) -> Transformable:
        return self._transformable

    def world(self, params: Optional[dict] = None) -> Tensor:
        """(4, 4) pose: params["<name>.to_world"] where given, else the
        unrandomized world on the camera's device."""
        if params is not None:
            key = self._transformable.name() + ".to_world"
            if key in params:
                return params[key]
        return torch.as_tensor(self._transformable.non_randomized_world(), dtype=torch.float32,
                               device=self._device)

    def origin(self, params: Optional[dict] = None) -> Tensor:
        return self.world(params)[:3, 3]

    # -- projection ----------------------------------------------------------------

    def points_to_ndc(self, points: Tensor, params: Optional[dict] = None) -> Tensor:
        """World points (N, 3) -> NDC (x, y in [-1, 1], z the view depth)."""
        return points_to_ndc(points, self.world(params), self._fov)

    # The reference's name.
    pointsToNDC = points_to_ndc


def _tan_half(fov_deg, device) -> Tensor:
    fov = torch.as_tensor(fov_deg, dtype=torch.float32, device=device)
    return torch.tan(torch.deg2rad(fov) / 2.0)


def points_to_ndc(points: Tensor, to_world: Tensor, fov_deg) -> Tensor:
    """World points (..., N, 3) seen from the pose `to_world` (..., 4, 4)
    with x-fov `fov_deg` -> NDC (..., N, 3): x, y in [-1, 1] across the
    field of view, z the view-space depth (positive in front).  Depths
    below 1e-8 in magnitude divide by 1e-8."""
    view = ffmath.transform_points(points, torch.linalg.inv(to_world))
    depth = -view[..., 2]
    tan_half = _tan_half(fov_deg, points.device)
    safe = torch.where(depth.abs() < 1e-8, 1e-8, depth)
    return torch.stack([view[..., 0] / (safe * tan_half), view[..., 1] / (safe * tan_half), depth],
                       dim=-1)


def directions_to_ndc(dirs_local: Tensor, fov_deg: float) -> Tensor:
    """Local-space directions (N, 3) (looking down -Z) -> NDC (N, 2)."""
    z = -dirs_local[:, 2]
    safe = torch.where(z.abs() < 1e-8, 1e-8, z)
    tan_half = _tan_half(fov_deg, dirs_local.device)
    return torch.stack(
        [dirs_local[:, 0] / (safe * tan_half), dirs_local[:, 1] / (safe * tan_half)], dim=-1
    )


def ndc_to_directions(ndc: Tensor, fov_deg) -> Tensor:
    """NDC points (N, 2) -> unit local directions (N, 3) looking down -Z."""
    tan_half = _tan_half(fov_deg, ndc.device)
    d = torch.stack([ndc[:, 0] * tan_half, ndc[:, 1] * tan_half, -torch.ones_like(ndc[:, 0])],
                    dim=-1)
    return ffmath.normalize_vectors(d)
