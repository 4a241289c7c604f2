"""Scene: the randomization API (port of fireflies_tpu/scene.py).

Build a scene, attach randomization intervals and samplers, switch
`train()/eval()`, then `compile()` it into

    randomize_params(gen, step) -> {param_key: Tensor}

one variant per call, drawn from the given `torch.Generator` (train mode)
or the deterministic sweep position `step` (eval mode).  Keys follow the
reference's Mitsuba-style names ("<mesh>.vertex_positions",
"<cam>.to_world", "<mat>.roughness", "<mat>.base_color.data" for a
material's texture, ...).

Scenes are built in code (add_mesh / add_light / add_material /
set_camera / ...), ingested from a flat Mitsuba-style param dict
(`Scene.from_params`, classifying keys by name prefix as the reference
does), or loaded from a file (`scene_io.load_scene`,
`utils.mitsuba_xml.scene_from_mitsuba_xml`).  `randomize()` is the
stateful convenience over `compile()`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fireflies_tpu_torch import sampling
from fireflies_tpu_torch.emitter import Light
from fireflies_tpu_torch.entity import Curve, Mesh, Transformable
from fireflies_tpu_torch.material import PRINCIPLED_DEFAULTS, Material
from fireflies_tpu_torch.utils import math as ffmath

Tensor = torch.Tensor

MESH_KEYS = ["mesh", "ply"]
CAM_KEYS = ["camera", "perspective", "perspectivecamera"]
PROJ_KEYS = ["projector"]
MAT_KEYS = ["mat", "bsdf", "brdf"]
LIGHT_KEYS = ["light", "spot", "emit"]
TEX_KEYS = ["tex"]

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
        self._curves: list[Curve] = []
        self._camera: Optional[Transformable] = None
        self._projector: Optional[Transformable] = None
        self._train = True
        self._eval_step = 0  # the sweep counter of the stateful randomize()
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

    def add_curve(self, curve: Curve) -> Curve:
        self._curves.append(curve)
        return curve

    def load_curve(self, path: str, name: str = "Curve", interp_delta: float = 0.01) -> Curve:
        """Import a Blender NURBS OBJ export as a Curve entity."""
        from fireflies_tpu_torch.utils.io import import_blender_nurbs_obj  # noqa: PLC0415

        return self.add_curve(Curve(name, import_blender_nurbs_obj(path),
                                    interp_delta=interp_delta))

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

    @classmethod
    def from_params(cls, params: dict) -> "Scene":
        """A scene from a flat parameter dict with Mitsuba-style keys: the
        top-level key prefix decides the entity type (MESH_KEYS, CAM_KEYS,
        PROJ_KEYS, LIGHT_KEYS, MAT_KEYS); float and length-3 leaves become
        constant attribute samplers; `<mesh>.vertex_positions` defines the
        geometry with its centroid split out.  A second perspective sensor
        becomes the projector (the reference's "PerspectiveCamera_1")."""
        scene = cls()
        base_keys = sorted({k.split(".")[0] for k in params})

        def sub_items(base):
            for k, v in params.items():
                if k.startswith(base + "."):
                    yield ".".join(k.split(".")[1:]), v

        def place(ent: Transformable, base: str) -> Transformable:
            if base + ".to_world" in params:
                ent.set_world(np.asarray(params[base + ".to_world"]))
            _register_leaf_attrs(ent, sub_items(base))
            ent.set_randomizable(False)
            return ent

        for base in base_keys:
            low = base.lower()
            if any(m in low for m in MESH_KEYS):
                verts = np.asarray(params[base + ".vertex_positions"], np.float32).reshape(-1, 3)
                centroid = verts.mean(axis=0)
                mesh = Mesh(base, verts - centroid, params.get(base + ".faces"))
                mesh.set_centroid(centroid)
                scene.add_mesh(mesh)
            elif any(m in low for m in CAM_KEYS):
                cam = place(Transformable(base), base)
                if scene.camera() is None:
                    scene.set_camera(cam)
                else:
                    scene.set_projector(cam)
            elif any(m in low for m in PROJ_KEYS):
                scene.set_projector(place(Transformable(base), base))
            elif any(m in low for m in LIGHT_KEYS):
                scene.add_light(place(Light(base), base))
            elif any(m in low for m in MAT_KEYS):
                mat = Material(base)
                _register_leaf_attrs(mat, sub_items(base))
                mat.set_randomizable(False)
                scene.add_material(mat)
        return scene

    # -- getters -------------------------------------------------------------------

    def meshes(self) -> list[Mesh]:
        return self._meshes

    def mesh_at(self, index: int) -> Mesh:
        return self._meshes[index]

    def mesh(self, name: str) -> Optional[Mesh]:
        return next((m for m in self._meshes if m.name() == name), None)

    get_mesh = mesh

    def lights(self) -> list[Light]:
        return self._lights

    def light_at(self, index: int) -> Light:
        return self._lights[index]

    def light(self, name: str) -> Optional[Light]:
        return next((li for li in self._lights if li.name() == name), None)

    get_light = light

    def materials(self) -> list[Material]:
        return self._materials

    def material_at(self, index: int) -> Material:
        return self._materials[index]

    def material(self, name: str) -> Optional[Material]:
        return next((m for m in self._materials if m.name() == name), None)

    get_material = material

    def camera(self) -> Optional[Transformable]:
        return self._camera

    def projector(self) -> Optional[Transformable]:
        return self._projector

    def curves(self) -> list[Curve]:
        return self._curves

    # -- mode ----------------------------------------------------------------------

    def train(self) -> None:
        self._train = True

    def eval(self) -> None:
        self._train = False
        self._eval_step = 0

    def is_training(self) -> bool:
        return self._train

    # -- compilation -------------------------------------------------------------

    def compile(self, device="cuda") -> Callable[[torch.Generator, int], dict[str, Tensor]]:
        """Build the randomize function for the current train/eval mode.

        Returns randomize_params(gen, step) -> flat {param_key: Tensor} with
        tensors on `device`, the card unless the caller asks for the CPU
        (`gen` must live there too).  Entities draw in a
        fixed order — curves (only a scene with curves has any), meshes,
        lights, camera, projector, materials — so one generator seeded from
        an int reproduces one variant.
        """
        train = self._train
        device = torch.device(device)
        curves = list(self._curves)
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
            for curve in curves:
                world_of(curve)

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

    # -- the stateful convenience --------------------------------------------------

    def randomize(self, seed_or_gen: torch.Generator | int | None = None,
                  device="cuda") -> dict[str, Tensor]:
        """One randomized parameter set on `device` (a generator's own device
        when one is given).  An int seeds a generator; None takes the sweep
        counter's value in eval mode and a random seed in train mode.  Eval
        mode advances the sweep counter by one a call."""
        if isinstance(seed_or_gen, torch.Generator):
            gen = seed_or_gen
        else:
            seed = seed_or_gen
            if seed is None:
                seed = self._eval_step if not self._train else int(np.random.randint(2**31))
            gen = torch.Generator(device=device).manual_seed(int(seed))
        step = self._eval_step
        if not self._train:
            self._eval_step += 1
        return self.compile(device=gen.device)(gen, step)

    def randomize_batch(self, gens, steps=None) -> list[dict[str, Tensor]]:
        """One parameter set per generator, variant i at `steps[i]` (all at
        step 0 without `steps`), on the generators' device: the list
        `SceneBridge.assemble` takes, as `main_path.scene_batch` builds it
        before attaching the projector."""
        gens = list(gens)
        if not gens:
            return []
        fn = self.compile(device=gens[0].device)
        steps = [0] * len(gens) if steps is None else steps
        return [fn(g, int(s)) for g, s in zip(gens, steps)]


def _register_leaf_attrs(ent: Transformable, items) -> None:
    """Float and vec3 leaves become constant attribute samplers; larger
    arrays (textures) and the geometry keys are left out."""
    for key, value in items:
        if key in ("to_world", "vertex_positions", "faces"):
            continue
        arr = np.asarray(value, np.float32)
        if arr.ndim == 0 or arr.size == 1:
            ent._float_attributes[key] = sampling.ConstantSampler.of(float(arr))
        elif arr.size == 3:
            ent._vec3_attributes[key] = sampling.ConstantSampler.of(arr.reshape(3))
