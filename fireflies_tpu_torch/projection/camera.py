"""Projective camera helpers (port of the pure functions of
fireflies_tpu/projection/camera.py: world points to NDC, and directions to
NDC and back).  The `Camera` class is not ported yet."""

from __future__ import annotations

import torch

from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor


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
