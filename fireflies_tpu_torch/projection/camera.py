"""Projective camera helpers (port of the part of
fireflies_tpu/projection/camera.py that the laser pattern uses)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def directions_to_ndc(dirs_local: Tensor, fov_deg: float) -> Tensor:
    """Local-space directions (N, 3) (looking down -Z) -> NDC (N, 2)."""
    z = -dirs_local[:, 2]
    safe = torch.where(z.abs() < 1e-8, 1e-8, z)
    fov = torch.tensor(fov_deg, dtype=torch.float32, device=dirs_local.device)
    tan_half = torch.tan(torch.deg2rad(fov) / 2.0)
    return torch.stack(
        [dirs_local[:, 0] / (safe * tan_half), dirs_local[:, 1] / (safe * tan_half)], dim=-1
    )
