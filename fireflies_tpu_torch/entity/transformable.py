"""Transformable: the randomizable-entity builder (port of
fireflies_tpu/entity/transformable.py; `Curve` is not ported yet).

A Transformable is a spec builder: per-axis rotation / translation
intervals, parent links and float/vec3 attribute samplers.
`sample_own_world(gen, step, train, device)` and `sample_attributes(...)`
draw one variant; `Scene.compile()` chains them into its randomize
function.  Pose composition: ``(T + centroid) @ R @ base_world``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fireflies_tpu_torch import sampling
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor


class Transformable:
    def __init__(self, name: str):
        self._name = name
        self._randomizable = False
        self._parent: Optional[Transformable] = None
        self._child: Optional[Transformable] = None

        zeros = np.zeros(3, np.float32)
        self._rotation_sampler: sampling.Sampler = sampling.UniformSampler.create(zeros, zeros)
        self._translation_sampler: sampling.Sampler = sampling.UniformSampler.create(zeros, zeros)

        self._world = np.eye(4, dtype=np.float32)
        self._centroid = np.zeros(3, dtype=np.float32)

        self._float_attributes: dict[str, sampling.Sampler] = {}
        self._vec3_attributes: dict[str, sampling.Sampler] = {}

    # -- identity / hierarchy -------------------------------------------------

    def name(self) -> str:
        return self._name

    def parent(self) -> Optional["Transformable"]:
        return self._parent

    def set_parent(self, parent: "Transformable") -> None:
        self._parent = parent
        parent._child = self

    # -- pose spec -------------------------------------------------------------

    def set_world(self, world) -> None:
        self._world = np.asarray(world, np.float32).reshape(4, 4)

    def set_centroid(self, centroid) -> None:
        self._centroid = np.asarray(centroid, np.float32).reshape(3)

    def rotate_x(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._rotation_sampler = self._rotation_sampler.set_index_interval(0, lo, hi)

    def rotate_y(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._rotation_sampler = self._rotation_sampler.set_index_interval(1, lo, hi)

    def rotate_z(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._rotation_sampler = self._rotation_sampler.set_index_interval(2, lo, hi)

    def translate_x(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._translation_sampler = self._translation_sampler.set_index_interval(0, lo, hi)

    def translate_y(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._translation_sampler = self._translation_sampler.set_index_interval(1, lo, hi)

    def translate_z(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._translation_sampler = self._translation_sampler.set_index_interval(2, lo, hi)

    # -- attribute spec ----------------------------------------------------------

    def add_float_key(self, key: str, minimum: float, maximum: float) -> None:
        self._randomizable = True
        self._float_attributes[key] = sampling.UniformSampler.create(minimum, maximum)

    def add_vec3_key(self, key: str, minimum, maximum) -> None:
        self._randomizable = True
        self._vec3_attributes[key] = sampling.UniformSampler.create(
            np.asarray(minimum, np.float32).reshape(3),
            np.asarray(maximum, np.float32).reshape(3),
        )

    def float_attributes(self) -> dict:
        return self._float_attributes

    def vec3_attributes(self) -> dict:
        return self._vec3_attributes

    # -- sampling (called from Scene's compiled randomize) ---------------------

    def _base_world(self, device) -> Tensor:
        return (ffmath.translation_matrix(torch.as_tensor(self._centroid, device=device))
                @ torch.as_tensor(self._world, device=device))

    def sample_own_world(self, gen, step, train: bool, device) -> Tensor:
        """Randomized local world; a non-randomizable entity still recomposes
        its centroid (vertices are stored centroid-aligned)."""
        if not self._randomizable:
            return self._base_world(device)
        t = self._translation_sampler.sample(gen, step, train, device)
        angles = self._rotation_sampler.sample(gen, step, train, device)
        t_mat = ffmath.translation_matrix(t + torch.as_tensor(self._centroid, device=device))
        r_mat = ffmath.to_mat4x4(ffmath.euler_to_rotation(angles))
        return t_mat @ r_mat @ torch.as_tensor(self._world, device=device)

    def sample_attributes(self, gen, step, train: bool, device) -> dict[str, Tensor]:
        """Sample every float/vec3 attribute; returns {attr_key: value}."""
        items = list(self._float_attributes.items()) + list(self._vec3_attributes.items())
        return {k: s.sample(gen, step, train, device) for k, s in items}
