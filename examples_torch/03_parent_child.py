"""Parent-child hierarchies: child follows randomized parent pose.

Twin of examples/03_parent_child.py.
"""

import numpy as np

from _common import render_randomized_variants, save_variants

import fireflies_tpu_torch as ff
from fireflies_tpu_torch.assets import procedural, scenes

if __name__ == "__main__":
    scene, kwargs = scenes.hello_world(randomize_rotation=False)
    parent = scene.mesh_at(0)
    parent.rotate_z(-3.14, 3.14)
    parent.translate_x(-0.5, 0.5)

    # A small satellite cube parented to the first.
    verts, faces = procedural.make_box(0.15)
    child = ff.Mesh("mesh-Satellite", verts - verts.mean(0), faces)
    world = np.eye(4, dtype=np.float32)
    world[:3, 3] = [0.9, 0.0, 0.0]  # offset in parent frame
    child.set_world(world)
    child.set_parent(parent)
    child.set_randomizable(True)
    scene.add_mesh(child, material="mat-Cube")

    images = render_randomized_variants(scene, kwargs)
    save_variants("03_parent_child", images)
