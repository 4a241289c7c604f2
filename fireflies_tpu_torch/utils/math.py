"""3D math utilities (PyTorch port of fireflies_tpu/utils/math.py).

Only what the ported main path calls: Euler rotations and homogeneous
transforms for scene randomization, the host-side numpy builders the asset
code uses, and the vector helpers of rays.py / projection.  All tensors are
float32; matmuls run in full fp32 because the package turns TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def rot_z(alpha: Tensor) -> Tensor:
    """3x3 rotation about +Z."""
    c, s = torch.cos(alpha), torch.sin(alpha)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
         torch.stack([zero, zero, one], -1)], -2)


def rot_y(alpha: Tensor) -> Tensor:
    """3x3 rotation about +Y."""
    c, s = torch.cos(alpha), torch.sin(alpha)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, zero, s], -1), torch.stack([zero, one, zero], -1),
         torch.stack([-s, zero, c], -1)], -2)


def rot_x(alpha: Tensor) -> Tensor:
    """3x3 rotation about +X."""
    c, s = torch.cos(alpha), torch.sin(alpha)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([one, zero, zero], -1), torch.stack([zero, c, -s], -1),
         torch.stack([zero, s, c], -1)], -2)


def euler_to_rotation(angles: Tensor) -> Tensor:
    """Euler XYZ angles (3,) -> 3x3 matrix ``Rz @ Ry @ Rx``."""
    return rot_z(angles[..., 2]) @ rot_y(angles[..., 1]) @ rot_x(angles[..., 0])


def to_mat4x4(mat3: Tensor) -> Tensor:
    m = torch.eye(4, dtype=mat3.dtype, device=mat3.device)
    m[:3, :3] = mat3
    return m


def translation_matrix(t: Tensor) -> Tensor:
    """(3,) translation -> 4x4 homogeneous translation matrix."""
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[:3, 3] = t
    return m


def scale_matrix(s: Tensor) -> Tensor:
    """(3,) scale -> 4x4 homogeneous scale matrix."""
    m = torch.eye(4, dtype=torch.float32, device=s.device)
    m[[0, 1, 2], [0, 1, 2]] = s
    return m


def look_at_np(origin, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Numpy 4x4 camera-to-world looking down -Z at `target`, +Y ~ up."""
    origin = np.asarray(origin, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - origin
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, up)
    right = right / (np.linalg.norm(right) + 1e-12)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = origin
    return m


def translation_matrix_np(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def convert_points_from_homogeneous(points: Tensor, eps: float = 1e-8) -> Tensor:
    w = points[..., 3:4]
    w = torch.where(w.abs() < eps, torch.where(w < 0, -eps, eps), w)
    return points[..., :3] / w


def transform_points(points: Tensor, matrix: Tensor) -> Tensor:
    """Apply a 4x4 homogeneous transform to (..., 3) points."""
    homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return convert_points_from_homogeneous(homo @ matrix.transpose(-1, -2))


def transform_directions(directions: Tensor, matrix: Tensor) -> Tensor:
    """Linear part of a 4x4 transform applied to (..., N, 3) directions;
    `matrix` may carry leading batch axes matching `directions`'."""
    return directions @ matrix[..., :3, :3].transpose(-1, -2)


def normalize_vectors(v: Tensor, eps: float = 1e-20) -> Tensor:
    """L2-normalize along the last axis."""
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)
