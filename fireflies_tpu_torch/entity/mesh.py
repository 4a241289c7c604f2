"""Mesh entity: vertex-level randomization (scale + animation).  Port of
fireflies_tpu/entity/mesh.py without OBJ loading, procedural animation
functions and shape models.

Pose composition ``(T + centroid) @ R @ S @ base_world``; vertices are
animated first, then transformed by the composed world.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fireflies_tpu_torch import sampling
from fireflies_tpu_torch.entity.transformable import Transformable
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor


class Mesh(Transformable):
    def __init__(self, name: str, vertices, faces=None, uvs=None, smooth=False):
        super().__init__(name)
        self._vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self._faces = np.asarray(faces, np.int32).reshape(-1, 3) if faces is not None else None
        self._uvs = np.asarray(uvs, np.float32) if uvs is not None else None
        self._smooth = bool(smooth)

        ones = np.ones(3, np.float32)
        self._scale_sampler: sampling.Sampler = sampling.UniformSampler.create(ones, ones)

        self._animated = False
        self._anim_data_train: Optional[np.ndarray] = None
        self._anim_data_eval: Optional[np.ndarray] = None
        self._animation_sampler: Optional[sampling.Sampler] = None

    # -- scale spec ----------------------------------------------------------------

    def set_scale_sampler(self, sampler: sampling.Sampler) -> None:
        self._randomizable = True
        self._scale_sampler = sampler

    def scale_x(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._scale_sampler = self._scale_sampler.set_index_interval(0, lo, hi)

    def scale_y(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._scale_sampler = self._scale_sampler.set_index_interval(1, lo, hi)

    def scale_z(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._scale_sampler = self._scale_sampler.set_index_interval(2, lo, hi)

    def scale(self, minimum, maximum) -> None:
        self._randomizable = True
        self._scale_sampler = self._scale_sampler.set_sample_interval(minimum, maximum)

    # -- animation spec ----------------------------------------------------------

    def animated(self) -> bool:
        return self._animated

    def add_animation(self, animation_data, eval_data=None) -> None:
        """Register stacked (F, V, 3) animation frames."""
        self._anim_data_train = np.asarray(animation_data, np.float32)
        self._anim_data_eval = (
            np.asarray(eval_data, np.float32) if eval_data is not None
            else self._anim_data_train
        )
        n_train = len(self._anim_data_train)
        n_eval = len(self._anim_data_eval)
        self._animation_sampler = sampling.AnimationSampler.create(0, n_train, 0, n_eval)
        self._animated = True
        self._randomizable = True

    # -- geometry access ----------------------------------------------------------

    def smooth(self) -> bool:
        """True when shading interpolates area-weighted vertex normals
        (Phong), else the mesh is flat-shaded."""
        return self._smooth

    def set_smooth(self, smooth: bool = True) -> None:
        self._smooth = bool(smooth)

    def faces(self) -> Optional[np.ndarray]:
        return self._faces

    def uvs(self) -> Optional[np.ndarray]:
        return self._uvs

    def get_vertices(self) -> np.ndarray:
        return self._vertices

    def num_vertices(self) -> int:
        return self._vertices.shape[0]

    # -- sampling ---------------------------------------------------------------

    def sample_own_world(self, gen, step, train: bool, device) -> Tensor:
        if not self._randomizable:
            return self._base_world(device)
        t = self._translation_sampler.sample(gen, step, train, device)
        angles = self._rotation_sampler.sample(gen, step, train, device)
        s = self._scale_sampler.sample(gen, step, train, device)
        t_mat = ffmath.translation_matrix(t + torch.as_tensor(self._centroid, device=device))
        r_mat = ffmath.to_mat4x4(ffmath.euler_to_rotation(angles))
        return t_mat @ r_mat @ ffmath.scale_matrix(s) @ torch.as_tensor(self._world, device=device)

    def sample_local_vertices(self, gen, step, train: bool, device) -> Tensor:
        """Animated (pre-world-transform) vertices."""
        if not self._animated:
            return torch.as_tensor(self._vertices, device=device)
        t = self._animation_sampler.sample(gen, step, train, device)
        data = self._anim_data_train if train else self._anim_data_eval
        idx = min(max(int(t), 0), data.shape[0] - 1)
        return torch.as_tensor(data[idx], device=device)
