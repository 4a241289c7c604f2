"""Transformable: the randomizable-entity builder (port of
fireflies_tpu/entity/transformable.py).

A Transformable is a spec builder: per-axis rotation / translation
intervals, parent links and float/vec3 attribute samplers.
`sample_own_world(gen, step, train, device)` and `sample_attributes(...)`
draw one variant; `Scene.compile()` chains them into its randomize
function.  Pose composition: ``(T + centroid) @ R @ base_world``, parent
first (``world = parent_world @ own``).  A `Curve` moves its children
along a NURBS path.
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

    def child(self) -> Optional["Transformable"]:
        return self._child

    def set_parent(self, parent: "Transformable") -> None:
        self._parent = parent
        parent._child = self

    # The reference's name.
    setParent = set_parent

    def relative(self) -> bool:
        return self._parent is not None

    def randomizable(self) -> bool:
        return self._randomizable

    def set_randomizable(self, value: bool) -> None:
        self._randomizable = value

    # -- pose spec -------------------------------------------------------------

    def set_world(self, world) -> None:
        self._world = np.asarray(world, np.float32).reshape(4, 4)

    def set_centroid(self, centroid) -> None:
        self._centroid = np.asarray(centroid, np.float32).reshape(3)

    def set_rotation_sampler(self, sampler: sampling.Sampler) -> None:
        self._randomizable = True
        self._rotation_sampler = sampler

    def set_translation_sampler(self, sampler: sampling.Sampler) -> None:
        self._randomizable = True
        self._translation_sampler = sampler

    def rotate_x(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._rotation_sampler = self._rotation_sampler.set_index_interval(0, lo, hi)

    def rotate_y(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._rotation_sampler = self._rotation_sampler.set_index_interval(1, lo, hi)

    def rotate_z(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._rotation_sampler = self._rotation_sampler.set_index_interval(2, lo, hi)

    def rotate(self, minimum, maximum) -> None:
        """Euler-angle intervals of all three axes at once ((3,) each)."""
        self._randomizable = True
        self._rotation_sampler = self._rotation_sampler.set_sample_interval(minimum, maximum)

    def translate_x(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._translation_sampler = self._translation_sampler.set_index_interval(0, lo, hi)

    def translate_y(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._translation_sampler = self._translation_sampler.set_index_interval(1, lo, hi)

    def translate_z(self, lo: float, hi: float) -> None:
        self._randomizable = True
        self._translation_sampler = self._translation_sampler.set_index_interval(2, lo, hi)

    def translate(self, minimum, maximum) -> None:
        """Translation intervals of all three axes at once ((3,) each)."""
        self._randomizable = True
        self._translation_sampler = self._translation_sampler.set_sample_interval(minimum, maximum)

    # -- attribute spec ----------------------------------------------------------

    def add_float_key(self, key: str, minimum: float, maximum: float) -> None:
        self._randomizable = True
        self._float_attributes[key] = sampling.UniformSampler.create(minimum, maximum)

    def add_float_sampler(self, key: str, sampler: sampling.Sampler) -> None:
        self._randomizable = True
        self._float_attributes[key] = sampler

    def add_vec3_key(self, key: str, minimum, maximum) -> None:
        self._randomizable = True
        self._vec3_attributes[key] = sampling.UniformSampler.create(
            np.asarray(minimum, np.float32).reshape(3),
            np.asarray(maximum, np.float32).reshape(3),
        )

    def add_vec3_sampler(self, key: str, sampler: sampling.Sampler) -> None:
        self._randomizable = True
        self._vec3_attributes[key] = sampler

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

    def non_randomized_world(self) -> np.ndarray:
        """The (4, 4) numpy world of the unrandomized pose: the parents'
        worlds times this entity's own, without the centroid."""
        if self._parent is None:
            return self._world
        return self._parent.non_randomized_world() @ self._world


class Curve(Transformable):
    """Moves its children along a NURBS path (`utils.nurbs.NURBSCurve`),
    oriented to the tangent: in train mode at t ~ U(0, 1), in eval mode at
    t = (step % n) * interp_delta with n = int(1 / interp_delta).  Its own
    world is translation(curve(t)) @ align(-Z -> tangent(t)) @ base_world."""

    def __init__(self, name: str, curve, interp_delta: float = 0.01):
        super().__init__(name)
        self._curve = curve
        self._interp_delta = float(interp_delta)
        self._randomizable = True

    def curve(self):
        return self._curve

    def sample_own_world(self, gen, step, train: bool, device) -> Tensor:
        if train:
            t = torch.rand((), generator=gen, device=device)
        else:
            n_steps = max(int(1.0 / self._interp_delta), 1)
            t = torch.tensor(float(int(step) % n_steps), dtype=torch.float32,
                             device=device) * self._interp_delta
        point = self._curve.evaluate(t)
        tangent = self._curve.tangent(t)
        forward = torch.tensor([0.0, 0.0, -1.0], device=device)
        m = ffmath.to_mat4x4(ffmath.rotation_matrix_from_vectors(forward, tangent))
        m[:3, 3] = point
        return m @ torch.as_tensor(self._world, device=device)
