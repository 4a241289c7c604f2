"""Procedural mesh assets.

The reference's example scene XMLs are absent from its snapshot
(SURVEY.md §4 note), so the framework authors its own analytic assets:
box, plane, sphere, cylinder/tube, and a procedural vocal-fold geometry for
the flagship structured-light workload (reference main.py / vocalfold_scene.py
use Blender-exported larynx meshes we reproduce parametrically).

All generators return (vertices (V, 3) float32, faces (F, 3) int32[, uvs]).
"""

from __future__ import annotations

import numpy as np


def make_plane(size: float = 1.0, resolution: int = 1):
    """XY plane centered at origin, +Z normal, with UVs."""
    n = resolution + 1
    xs = np.linspace(-size, size, n, dtype=np.float32)
    ys = np.linspace(-size, size, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    verts = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).reshape(-1, 3)
    uvs = np.stack(
        [(gx + size) / (2 * size), (gy + size) / (2 * size)], axis=-1
    ).reshape(-1, 2)
    faces = []
    for j in range(resolution):
        for i in range(resolution):
            a = j * n + i
            b = a + 1
            c = a + n
            d = c + 1
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts.astype(np.float32), np.asarray(faces, np.int32), uvs.astype(np.float32)


def make_box(half_extent: float = 1.0):
    """Axis-aligned cube centered at origin (12 triangles, outward normals)."""
    h = half_extent
    verts = np.array(
        [
            [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
            [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],
        ],
        np.float32,
    )
    quads = [
        (0, 3, 2, 1),  # -z
        (4, 5, 6, 7),  # +z
        (0, 1, 5, 4),  # -y
        (2, 3, 7, 6),  # +y
        (0, 4, 7, 3),  # -x
        (1, 2, 6, 5),  # +x
    ]
    faces = []
    for a, b, c, d in quads:
        faces.append([a, b, c])
        faces.append([a, c, d])
    return verts, np.asarray(faces, np.int32)


def make_sphere(radius: float = 1.0, rings: int = 16, segments: int = 32):
    """UV sphere centered at origin."""
    verts, uvs = [], []
    for r in range(rings + 1):
        theta = np.pi * r / rings
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            verts.append(
                [
                    radius * np.sin(theta) * np.cos(phi),
                    radius * np.cos(theta),
                    radius * np.sin(theta) * np.sin(phi),
                ]
            )
            uvs.append([s / segments, 1.0 - r / rings])
    faces = []
    stride = segments + 1
    for r in range(rings):
        for s in range(segments):
            a = r * stride + s
            b = a + 1
            c = a + stride
            d = c + 1
            if r != 0:
                faces.append([a, c, b])
            if r != rings - 1:
                faces.append([b, c, d])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
    )


def make_tube(radius: float = 1.0, length: float = 2.0, segments: int = 24, rings: int = 8):
    """Open cylinder along -Z (an endoscopy 'trachea' tube: camera inside)."""
    verts, uvs = [], []
    for r in range(rings + 1):
        z = -length * r / rings
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            verts.append([radius * np.cos(phi), radius * np.sin(phi), z])
            uvs.append([s / segments, r / rings])
    faces = []
    stride = segments + 1
    for r in range(rings):
        for s in range(segments):
            a = r * stride + s
            b = a + 1
            c = a + stride
            d = c + 1
            # Inward-facing winding (viewed from inside the tube).
            faces.append([a, b, d])
            faces.append([a, d, c])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
    )


def make_vocalfold(
    width: float = 1.0,
    depth: float = 1.2,
    gap: float = 0.08,
    fold_height: float = 0.35,
    resolution: int = 24,
    t: float = 0.0,
):
    """Procedural bilateral vocal-fold geometry.

    Two smooth medial folds separated by a glottal gap, modeled as a height
    field z(x, y) = fold_height * exp(-(|x| - gap)^2 / 2s^2) over an
    [-width, width] x [-depth, depth] sheet, with `t` in [0, 1] opening the
    gap (phonation cycle) — usable as a procedural animation function.

    Returns (vertices, faces, uvs); the camera typically looks down -Z from
    above (supraglottal view), matching the laryngoscopy setup of the paper.
    """
    n = resolution + 1
    xs = np.linspace(-width, width, n, dtype=np.float32)
    ys = np.linspace(-depth, depth, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)

    open_gap = gap + 0.25 * width * t * np.abs(np.sin(np.pi * gy / depth))
    s = 0.35 * width
    z = fold_height * np.exp(-((np.abs(gx) - open_gap - s) ** 2) / (2 * s * s))
    # Slight anterior-posterior taper.
    z = z * (0.75 + 0.25 * np.cos(np.pi * gy / (2 * depth)))

    verts = np.stack([gx, gy, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack(
        [(gx + width) / (2 * width), (gy + depth) / (2 * depth)], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    faces = []
    for j in range(resolution):
        for i in range(resolution):
            a = j * n + i
            b = a + 1
            c = a + n
            d = c + 1
            faces.append([a, d, b])
            faces.append([a, c, d])
    return verts, np.asarray(faces, np.int32), uvs


def vocalfold_animation_frames(
    n_frames: int = 8, resolution: int = 24, **kwargs
) -> np.ndarray:
    """(F, V, 3) phonation-cycle frames for Mesh.add_animation."""
    frames = []
    for f in range(n_frames):
        t = 0.5 * (1 - np.cos(2 * np.pi * f / n_frames))  # smooth 0->1->0
        v, _, _ = make_vocalfold(resolution=resolution, t=t, **kwargs)
        frames.append(v)
    return np.stack(frames)
