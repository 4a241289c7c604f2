"""Host-side IO (port of the part of fireflies_tpu/utils/io.py that the
camera uses: the projection matrix)."""

from __future__ import annotations

import math

import numpy as np


def build_projection_matrix(fov: float, near_clip: float, far_clip: float) -> np.ndarray:
    """Perspective calibration matrix K (4x4, float32 numpy), pytorch3d
    convention: fov in degrees, square pixels, the camera looking down -Z
    (z_sign = -1), NDC z mapped to [0, 1]."""
    tan_half = math.tan((math.pi / 180.0) * float(fov) / 2.0)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = 1.0 / tan_half
    k[1, 1] = 1.0 / tan_half
    z_sign = -1.0
    k[3, 2] = z_sign
    k[2, 2] = z_sign * far_clip / (far_clip - near_clip)
    k[2, 3] = -(far_clip * near_clip) / (far_clip - near_clip)
    return k
