"""Canonical scene builders (port of fireflies_tpu/assets/scenes.py).

  * hello_world — one box, camera, point light
  * vocalfold   — procedural larynx: vocal folds inside a tube, spot light,
                  laser projector (the main-path workload)

Each builder returns (scene, bridge_kwargs): pass the kwargs to SceneBridge.
"""

from __future__ import annotations

import numpy as np

import fireflies_tpu_torch as ff
from fireflies_tpu_torch.assets import procedural
from fireflies_tpu_torch.utils import math as ffmath


def hello_world(randomize_rotation: bool = True):
    """Single cube + camera + point light."""
    scene = ff.Scene()

    verts, faces = procedural.make_box(0.5)
    mesh = ff.Mesh("mesh-Cube", verts - verts.mean(0), faces)
    mesh.set_centroid(verts.mean(0))
    if randomize_rotation:
        mesh.rotate_z(-np.pi, np.pi)
    scene.add_mesh(mesh, material="mat-Cube")
    scene.add_material(ff.Material("mat-Cube", base_color=(0.8, 0.3, 0.25)))

    cam = ff.Transformable("PerspectiveCamera")
    cam.set_world(ffmath.look_at_np((0.0, 0.8, 2.5), (0.0, 0.0, 0.0)))
    scene.set_camera(cam)

    light = ff.Light("light-Point", kind="point", intensity=(12.0, 12.0, 12.0))
    light.set_world(ffmath.translation_matrix_np([1.5, 2.0, 2.0]))
    scene.add_light(light)

    return scene, {"camera_fov": 45.0, "background": (0.0, 0.0, 0.0)}


def vocalfold(resolution: int = 24, n_anim_frames: int = 8, with_projector: bool = True,
              smooth: bool = False):
    """The structured-light laryngoscopy scene: camera above the folds
    looking down -Z, a spot light beside it, a laser projector offset by a
    small baseline.  `smooth` shades both meshes with interpolated vertex
    normals (the reference's OBJ default); flat is the default."""
    scene = ff.Scene()

    vf_verts, vf_faces, vf_uvs = procedural.make_vocalfold(resolution=resolution)
    centroid = vf_verts.mean(0)
    vf = ff.Mesh("mesh-Vocalfold", vf_verts - centroid, vf_faces, vf_uvs, smooth=smooth)
    vf.set_centroid(centroid)
    frames = procedural.vocalfold_animation_frames(n_anim_frames, resolution=resolution)
    vf.add_animation(frames - centroid, frames - centroid)
    scene.add_mesh(vf, material="mat-Mucosa")

    tube_verts, tube_faces, tube_uvs = procedural.make_tube(
        radius=1.6, length=3.0, segments=24, rings=6
    )
    tube_world = np.eye(4, dtype=np.float32)
    tube_world[:3, 3] = [0.0, 0.0, 2.0]
    larynx = ff.Mesh("mesh-Larynx", tube_verts, tube_faces, tube_uvs, smooth=smooth)
    larynx.set_world(tube_world)
    scene.add_mesh(larynx, material="mat-Tissue")

    scene.add_material(ff.Material(
        "mat-Mucosa", base_color=(0.78, 0.35, 0.34), roughness=0.35, specular=0.6))
    scene.add_material(ff.Material("mat-Tissue", base_color=(0.72, 0.30, 0.30), roughness=0.5))

    cam = ff.Transformable("PerspectiveCamera")
    cam.set_world(ffmath.look_at_np((0.0, 0.0, 1.9), (0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)))
    scene.set_camera(cam)

    spot = ff.Light("emit-Spot", kind="spot", intensity=(12.0, 12.0, 12.0), cutoff_angle=40.0)
    spot.set_world(ffmath.look_at_np((0.0, 0.0, 1.95), (0.0, 0.0, 0.0)))
    scene.add_light(spot)

    if with_projector:
        proj = ff.Transformable("Projector")
        proj.set_world(ffmath.look_at_np((0.35, 0.0, 1.9), (0.0, 0.0, 0.0)))
        scene.set_projector(proj)

    bridge_kwargs = {
        "camera_fov": 60.0,
        "projector_fov": 30.0,
        "projector_scale": 20.0,
        "background": (0.0, 0.0, 0.0),
    }
    return scene, bridge_kwargs
