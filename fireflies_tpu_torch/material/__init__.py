"""Materials (port of fireflies_tpu/material).

A Material is a Transformable whose randomization touches only its
float/vec3 attributes; it records the principled-BSDF default parameters
the bridge assembles into the material table, and optional maps: a
base-colour texture (H, W, 3), emitted by `Scene.compile()` as
"<mat>.base_color.data"; a roughness map (H, W) in [0, 1]; a tangent-space
normal map (H, W, 3), RGB in [0, 1] with n = 2 rgb - 1 (the mesh needs
uvs).  Its spatial operations (rotate, translate, set_parent, set_world)
warn, since they have no effect on shading.
"""

from __future__ import annotations

from fireflies_tpu_torch.entity.transformable import Transformable
from fireflies_tpu_torch.utils import warnings as ffwarn

PRINCIPLED_DEFAULTS: dict[str, object] = {
    "base_color": (0.8, 0.8, 0.8),
    "roughness": 0.5,
    "metallic": 0.0,
    "specular": 0.5,
    "spec_tint": 0.0,
    "clearcoat": 0.0,
    "clearcoat_gloss": 1.0,
    "sheen": 0.0,
    "sheen_tint": 0.5,
    "anisotropic": 0.0,
    "spec_trans": 0.0,
    "flatness": 0.0,
    "ior": 1.5,
    "thin": 0.0,
    "emission": (0.0, 0.0, 0.0),
}


class Material(Transformable):
    def __init__(self, name: str, bsdf: str = "principled", **params):
        super().__init__(name)
        self._bsdf = bsdf
        self._params: dict[str, object] = dict(PRINCIPLED_DEFAULTS)
        self._params.update(params)
        self._texture = None
        self._roughness_texture = None
        self._normal_texture = None

    def bsdf(self) -> str:
        return self._bsdf

    def params(self) -> dict:
        return self._params

    def set_param(self, key: str, value) -> None:
        self._params[key] = value

    def set_texture(self, texture) -> None:
        self._texture = texture

    def texture(self):
        return self._texture

    def set_roughness_texture(self, texture) -> None:
        self._roughness_texture = texture

    def roughness_texture(self):
        return self._roughness_texture

    def set_normal_texture(self, texture) -> None:
        self._normal_texture = texture

    def normal_texture(self):
        return self._normal_texture

    @ffwarn.rotation_assignment_warning
    def rotate_x(self, *a):
        return super().rotate_x(*a)

    @ffwarn.rotation_assignment_warning
    def rotate_y(self, *a):
        return super().rotate_y(*a)

    @ffwarn.rotation_assignment_warning
    def rotate_z(self, *a):
        return super().rotate_z(*a)

    @ffwarn.rotation_assignment_warning
    def rotate(self, *a):
        return super().rotate(*a)

    @ffwarn.translation_assignment_warning
    def translate_x(self, *a):
        return super().translate_x(*a)

    @ffwarn.translation_assignment_warning
    def translate_y(self, *a):
        return super().translate_y(*a)

    @ffwarn.translation_assignment_warning
    def translate_z(self, *a):
        return super().translate_z(*a)

    @ffwarn.translation_assignment_warning
    def translate(self, *a):
        return super().translate(*a)

    @ffwarn.relative_assignment_warning
    def set_parent(self, *a):
        return super().set_parent(*a)

    @ffwarn.world_assignment_warning
    def set_world(self, *a):
        return super().set_world(*a)


__all__ = ["Material", "PRINCIPLED_DEFAULTS"]
