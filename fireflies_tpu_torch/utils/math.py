"""3D math utilities (PyTorch port of fireflies_tpu/utils/math.py).

Euler rotations and homogeneous transforms for scene randomization, the
host-side numpy builders the asset code uses, look-at and vector-to-vector
rotations, and the vector helpers (normalization, min-max normalization,
dot).  All tensors are float32; matmuls run in full fp32 because the
package turns TF32 off.
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


# The reference's names for the three rotations (utils/math.py:83-88).
get_yaw_transform = rot_z
get_pitch_transform = rot_y
get_roll_transform = rot_x
get_z_transform = rot_z
get_y_transform = rot_y
get_x_transform = rot_x


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


def skew(v: Tensor) -> Tensor:
    """Skew-symmetric cross-product matrix (3, 3) of a 3-vector."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([zero, -v[2], v[1]]), torch.stack([v[2], zero, -v[0]]),
                        torch.stack([-v[1], v[0], zero])])


def rotation_matrix_from_vectors(v1: Tensor, v2: Tensor) -> Tensor:
    """Rotation matrix (3, 3) taking direction v1 onto v2 (Rodrigues): the
    identity when they are parallel, a half turn about a perpendicular axis
    when they are opposite."""
    v1 = v1 / torch.linalg.vector_norm(v1)
    v2 = v2 / torch.linalg.vector_norm(v2)
    c = torch.linalg.cross(v1, v2)
    d = torch.dot(v1, v2)
    s2 = torch.dot(c, c)  # sin^2 of the angle
    eye = torch.eye(3, dtype=v1.dtype, device=v1.device)
    k = skew(c)
    safe_s2 = torch.where(s2 < 1e-12, 1.0, s2)
    r = eye + k + (k @ k) * ((1.0 - d) / safe_s2)
    perp = torch.where(v1[0].abs() < 0.9, eye[0], eye[1])
    axis = torch.linalg.cross(v1, perp)
    k180 = skew(axis / torch.linalg.vector_norm(axis))
    r_anti = eye + 2.0 * (k180 @ k180)
    return torch.where(s2 < 1e-12, torch.where(d > 0.0, eye, r_anti), r)


def look_at(origin, target, up) -> Tensor:
    """4x4 camera-to-world (float32, on `origin`'s device) looking down -Z
    at `target`, +Y ~ up."""
    origin = torch.as_tensor(origin, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=origin.device)
    up = torch.as_tensor(up, dtype=torch.float32, device=origin.device)
    fwd = target - origin
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    true_up = torch.linalg.cross(right, fwd)
    m = torch.eye(4, dtype=torch.float32, device=origin.device)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = origin
    return m


def transform_points_np(points, matrix) -> np.ndarray:
    """Numpy twin of transform_points for host-side scene building."""
    points = np.asarray(points, np.float32)
    homo = np.concatenate([points, np.ones((len(points), 1), np.float32)], -1)
    out = homo @ np.asarray(matrix, np.float32).T
    w = out[:, 3:4]
    w = np.where(np.abs(w) < 1e-8, 1e-8, w)
    return out[:, :3] / w


def convert_points_to_homogeneous(points: Tensor) -> Tensor:
    """(..., 3) -> (..., 4) with w = 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def transform_normals(normals: Tensor, matrix: Tensor) -> Tensor:
    """Normals (..., 3) under the inverse transpose of the 4x4 transform's
    linear part, re-normalized."""
    inv_t = torch.linalg.inv(matrix[:3, :3]).T
    out = normals @ inv_t.T
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-20)


def random_between(gen: torch.Generator, minimum, maximum) -> Tensor:
    """U(minimum, maximum) elementwise, drawn from `gen` on its device."""
    minimum = torch.as_tensor(minimum, dtype=torch.float32, device=gen.device)
    maximum = torch.as_tensor(maximum, dtype=torch.float32, device=gen.device)
    shape = torch.broadcast_shapes(minimum.shape, maximum.shape)
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (maximum - minimum) + minimum


def normalize(x: Tensor) -> Tensor:
    """Min-max normalize to [0, 1] (a constant tensor maps to 0)."""
    lo, hi = x.min(), x.max()
    return (x - lo) / torch.where(hi - lo == 0, 1.0, hi - lo)


def normalize_channelwise(x: Tensor, axis: int = -1) -> Tensor:
    """Min-max normalize each channel along `axis` over the other axes."""
    dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    lo = x.amin(dim=dims, keepdim=True)
    hi = x.amax(dim=dims, keepdim=True)
    return (x - lo) / torch.where(hi - lo == 0, 1.0, hi - lo)


def dot(a: Tensor, b: Tensor, keepdims: bool = False) -> Tensor:
    """Last-axis dot product."""
    return (a * b).sum(dim=-1, keepdim=keepdims)
