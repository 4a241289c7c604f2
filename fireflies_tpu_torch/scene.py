"""Scene: the randomization API (port of fireflies_tpu/scene.py).

Build a scene, attach randomization intervals and samplers, switch
`train()/eval()`, then `compile()` it into

    randomize_params(gen, step) -> {param_key: Tensor}

one variant per call, drawn from the given `torch.Generator` (train mode)
or the deterministic sweep position `step` (eval mode).  Keys follow the
reference's Mitsuba-style names ("<mesh>.vertex_positions",
"<cam>.to_world", "<mat>.roughness", "<mat>.base_color.data" for a
material's texture, ...).  `Curve`s, `from_params` and the
stateful `randomize()` convenience are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fireflies_tpu_torch.emitter import Light
from fireflies_tpu_torch.entity import Mesh, Transformable
from fireflies_tpu_torch.material import PRINCIPLED_DEFAULTS, Material
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor

_CANONICAL_PARAMS = set(PRINCIPLED_DEFAULTS) | {"intensity", "x_fov", "fov", "cutoff_angle"}


def canonical_param(key: str) -> Optional[str]:
    """Canonical parameter name of a (possibly nested) attribute key, e.g.
    'brdf_0.roughness.value' -> 'roughness'; texture keys ('.data') map to
    None."""
    if key.split(".")[-1] == "data":
        return None
    for part in key.split("."):
        if part in _CANONICAL_PARAMS:
            return "fov" if part == "x_fov" else part
    return None


class Scene:
    def __init__(self):
        self._meshes: list[Mesh] = []
        self._lights: list[Light] = []
        self._materials: list[Material] = []
        self._camera: Optional[Transformable] = None
        self._projector: Optional[Transformable] = None
        self._train = True
        self._mesh_material: dict[str, str] = {}

    # -- construction ------------------------------------------------------------

    def add_mesh(self, mesh: Mesh, material: str | None = None) -> Mesh:
        self._meshes.append(mesh)
        if material is not None:
            self._mesh_material[mesh.name()] = material
        return mesh

    def add_light(self, light: Light) -> Light:
        self._lights.append(light)
        return light

    def add_material(self, material: Material) -> Material:
        self._materials.append(material)
        return material

    def set_camera(self, camera: Transformable) -> Transformable:
        self._camera = camera
        return camera

    def set_projector(self, projector: Transformable) -> Transformable:
        self._projector = projector
        return projector

    def bind_material(self, mesh_name: str, material_name: str) -> None:
        self._mesh_material[mesh_name] = material_name

    def mesh_material_binding(self) -> dict[str, str]:
        return dict(self._mesh_material)

    # -- getters -------------------------------------------------------------------

    def meshes(self) -> list[Mesh]:
        return self._meshes

    def mesh(self, name: str) -> Optional[Mesh]:
        return next((m for m in self._meshes if m.name() == name), None)

    def lights(self) -> list[Light]:
        return self._lights

    def light(self, name: str) -> Optional[Light]:
        return next((li for li in self._lights if li.name() == name), None)

    def materials(self) -> list[Material]:
        return self._materials

    def material(self, name: str) -> Optional[Material]:
        return next((m for m in self._materials if m.name() == name), None)

    def camera(self) -> Optional[Transformable]:
        return self._camera

    def projector(self) -> Optional[Transformable]:
        return self._projector

    # -- mode ----------------------------------------------------------------------

    def train(self) -> None:
        self._train = True

    def eval(self) -> None:
        self._train = False

    def is_training(self) -> bool:
        return self._train

    # -- compilation -------------------------------------------------------------

    def compile(self, device="cuda") -> Callable[[torch.Generator, int], dict[str, Tensor]]:
        """Build the randomize function for the current train/eval mode.

        Returns randomize_params(gen, step) -> flat {param_key: Tensor} with
        tensors on `device`, the card unless the caller asks for the CPU
        (`gen` must live there too).  Entities draw in a
        fixed order — meshes, lights, camera, projector, materials — so one
        generator seeded from an int reproduces one variant.
        """
        train = self._train
        device = torch.device(device)
        meshes = list(self._meshes)
        lights = list(self._lights)
        materials = list(self._materials)
        camera = self._camera
        projector = self._projector
        # Attached base-colour textures, each moved to the device once (again
        # after a set_texture): every variant of every call passes the same
        # tensor, which the bridge then keeps as one map for the batch.
        uploaded: dict[str, tuple] = {}

        def texture_of(mat: Material) -> Tensor:
            tex = mat.texture()
            if uploaded.get(mat.name(), (None,))[0] is not tex:
                uploaded[mat.name()] = (tex, torch.as_tensor(tex, dtype=torch.float32,
                                                              device=device))
            return uploaded[mat.name()][1]

        def randomize_params(gen: torch.Generator, step: int = 0) -> dict[str, Tensor]:
            worlds: dict[int, Tensor] = {}

            def world_of(ent: Transformable) -> Tensor:
                if id(ent) not in worlds:
                    own = ent.sample_own_world(gen, step, train, device)
                    parent = ent.parent()
                    worlds[id(ent)] = world_of(parent) @ own if parent is not None else own
                return worlds[id(ent)]

            params: dict[str, Tensor] = {}

            def emit_attrs(ent: Transformable) -> None:
                for attr_key, value in ent.sample_attributes(gen, step, train, device).items():
                    params[ent.name() + "." + attr_key] = value
                    canon = canonical_param(attr_key)
                    if canon is not None and canon != attr_key:
                        params[ent.name() + "." + canon] = value

            for mesh in meshes:
                w = world_of(mesh)
                local = mesh.sample_local_vertices(gen, step, train, device)
                params[mesh.name() + ".vertex_positions"] = ffmath.transform_points(local, w)
                params[mesh.name() + ".to_world"] = w

            for light in lights:
                params[light.name() + ".to_world"] = world_of(light)
                for dkey, dval in light.defaults().items():
                    params[light.name() + "." + dkey] = torch.as_tensor(
                        dval, dtype=torch.float32, device=device)
                emit_attrs(light)

            for ent in (camera, projector):
                if ent is not None:
                    params[ent.name() + ".to_world"] = world_of(ent)
                    emit_attrs(ent)

            for mat in materials:
                for pname, pval in mat.params().items():
                    params[mat.name() + "." + pname] = torch.as_tensor(
                        pval, dtype=torch.float32, device=device)
                if mat.texture() is not None:
                    params[mat.name() + ".base_color.data"] = texture_of(mat)
                emit_attrs(mat)
            return params

        return randomize_params
