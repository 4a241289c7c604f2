"""YAML scene descriptions -> Scene + SceneBridge keyword arguments (port of
fireflies_tpu/scene_io.py).

The package's own declarative scene format with its randomization spec,
so that a whole train()/eval() setup is one file, read and written by
`utils.io`'s YAML reader and writer:

```yaml
camera:
  position: [0, 0.8, 2.5]
  look_at: [0, 0, 0]
  fov: 45
  randomize:
    rotate_z: [-0.5, 0.5]
    translate_x: [-0.1, 0.1]
    fov: [40, 60]            # float attribute interval
meshes:
  - name: mesh-Cube
    primitive: box           # box | plane | sphere | tube | vocalfold
    size: 0.5                # or: obj: path/to/mesh.obj
    material: mat-Cube
    randomize:
      rotate_y: [-3.14, 3.14]
      scale: [[0.5, 0.5, 0.5], [2, 2, 2]]
    animation:
      obj_dir: frames/       # or procedural animations by name
materials:
  - name: mat-Cube
    base_color: [0.8, 0.3, 0.25]
    roughness: 0.4
    randomize:
      roughness: [0.1, 0.9]
lights:
  - name: light-Main
    kind: point              # point | spot
    position: [1.5, 2, 2]
    intensity: [12, 12, 12]
    randomize:
      intensity_scalar: [5, 25]   # UniformScalarToVec3
projector:
  position: [0.35, 0, 1.9]
  look_at: [0, 0, 0]
  fov: 30
background: [0, 0, 0]
```
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fireflies_tpu_torch.assets import procedural
from fireflies_tpu_torch.emitter import Light
from fireflies_tpu_torch.entity import Mesh, Transformable
from fireflies_tpu_torch.material import Material
from fireflies_tpu_torch.sampling import UniformScalarToVec3Sampler
from fireflies_tpu_torch.scene import Scene
from fireflies_tpu_torch.utils import io as ffio
from fireflies_tpu_torch.utils import math as ffmath

_PRIMITIVES = {
    "box": lambda spec: procedural.make_box(spec.get("size", 1.0)) + (None,),
    "plane": lambda spec: procedural.make_plane(spec.get("size", 1.0), spec.get("resolution", 1)),
    "sphere": lambda spec: procedural.make_sphere(spec.get("size", 1.0), spec.get("rings", 16),
                                                  spec.get("segments", 32)),
    "tube": lambda spec: procedural.make_tube(spec.get("radius", 1.0), spec.get("length", 2.0)),
    "vocalfold": lambda spec: procedural.make_vocalfold(resolution=spec.get("resolution", 24)),
}


def _world_from(spec: dict) -> np.ndarray:
    if "world" in spec:
        return np.asarray(spec["world"], np.float32).reshape(4, 4)
    position = np.asarray(spec.get("position", [0.0, 0.0, 0.0]), np.float32)
    if "look_at" in spec:
        return ffmath.look_at_np(position, spec["look_at"], spec.get("up", [0.0, 1.0, 0.0]))
    return ffmath.translation_matrix_np(position)


def _apply_randomize(entity, spec: dict) -> None:
    """Apply a randomization block to any Transformable."""
    for key, rng in (spec or {}).items():
        if key in ("rotate", "translate", "scale"):
            getattr(entity, key)(np.asarray(rng[0], np.float32), np.asarray(rng[1], np.float32))
        elif key.startswith(("rotate_", "translate_", "scale_")):
            getattr(entity, key)(float(rng[0]), float(rng[1]))
        elif key == "intensity_scalar":
            entity.add_vec3_sampler("intensity.value",
                                    UniformScalarToVec3Sampler.create(float(rng[0]), float(rng[1])))
        elif key == "fov":
            entity.add_float_key("x_fov", float(rng[0]), float(rng[1]))
        else:
            lo, hi = rng
            if np.asarray(lo, np.float32).size == 3:
                entity.add_vec3_key(key, lo, hi)
            else:
                entity.add_float_key(key, float(lo), float(hi))


def load_scene(path: str | Path | dict):
    """Load a YAML scene description (a file, or its dict); returns (Scene,
    bridge_kwargs).  Paths in the file (`obj`, `animation.obj_dir`) are
    relative to it.  The file is read by `utils.io.yaml_loads`, which reads
    what `yaml.safe_load` reads of block and flow collections, scalars,
    anchors and aliases, the '<<' merge key and block scalars (`|`, `>`);
    any other YAML construct (a tag, a directive, a complex key) raises
    ValueError."""
    desc = path if isinstance(path, dict) else ffio.read_config_yaml(path)
    base_dir = Path(path).parent if not isinstance(path, dict) else Path(".")

    scene = Scene()

    for mspec in desc.get("materials", []):
        mat = Material(mspec["name"], **{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in mspec.items()
                                         if k not in ("name", "randomize", "texture")})
        if "texture" in mspec:
            mat.set_texture(np.asarray(mspec["texture"], np.float32))
        _apply_randomize(mat, mspec.get("randomize"))
        scene.add_material(mat)

    for spec in desc.get("meshes", []):
        if "obj" in spec:
            data = ffio.load_obj(base_dir / spec["obj"])
            verts, faces, uvs = data["vertices"], data["faces"], data.get("uvs")
        else:
            out = _PRIMITIVES[spec.get("primitive", "box")](spec)
            verts, faces, uvs = out[0], out[1], out[2] if len(out) > 2 else None
        # The placement is baked into the vertices, which are then stored
        # centroid-aligned: randomization rotates and scales about the
        # centroid.
        if any(k in spec for k in ("world", "position", "look_at")):
            verts = ffmath.transform_points_np(verts, _world_from(spec))
        centroid = verts.mean(axis=0)
        mesh = Mesh(spec["name"], verts - centroid, faces, uvs)
        mesh.set_centroid(centroid)
        _apply_randomize(mesh, spec.get("randomize"))
        anim = spec.get("animation") or {}
        if "obj_dir" in anim:
            mesh.add_train_animation_from_obj(str(base_dir / anim["obj_dir"]))
            mesh.add_eval_animation_from_obj(str(base_dir / anim.get("eval_obj_dir",
                                                                     anim["obj_dir"])))
        scene.add_mesh(mesh, material=spec.get("material"))

    for lspec in desc.get("lights", []):
        defaults = {k: tuple(v) if isinstance(v, list) else v for k, v in lspec.items()
                    if k not in ("name", "kind", "position", "look_at", "up", "world", "randomize")}
        light = Light(lspec["name"], kind=lspec.get("kind", "point"), **defaults)
        light.set_world(_world_from(lspec))
        _apply_randomize(light, lspec.get("randomize"))
        scene.add_light(light)

    bridge_kwargs: dict = {}
    cspec = desc.get("camera")
    if cspec:
        cam = Transformable(cspec.get("name", "PerspectiveCamera"))
        cam.set_world(_world_from(cspec))
        _apply_randomize(cam, cspec.get("randomize"))
        scene.set_camera(cam)
        bridge_kwargs["camera_fov"] = float(cspec.get("fov", 45.0))
        bridge_kwargs["camera_near"] = float(cspec.get("near", 0.01))
        bridge_kwargs["camera_far"] = float(cspec.get("far", 1000.0))

    pspec = desc.get("projector")
    if pspec:
        proj = Transformable(pspec.get("name", "Projector"))
        proj.set_world(_world_from(pspec))
        _apply_randomize(proj, pspec.get("randomize"))
        scene.set_projector(proj)
        bridge_kwargs["projector_fov"] = float(pspec.get("fov", 30.0))
        bridge_kwargs["projector_scale"] = float(pspec.get("scale", 1.0))

    if "background" in desc:
        bridge_kwargs["background"] = tuple(desc["background"])

    return scene, bridge_kwargs


def save_scene_description(desc: dict, path: str | Path) -> None:
    """Write a scene description as YAML (`utils.io.write_yaml`)."""
    ffio.write_yaml(desc, path)
