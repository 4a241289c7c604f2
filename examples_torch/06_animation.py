"""Procedural vertex animation.

Twin of examples/06_animation.py.
"""

import torch

from _common import render_randomized_variants, save_variants

from fireflies_tpu_torch.assets import scenes

if __name__ == "__main__":
    scene, kwargs = scenes.hello_world(randomize_rotation=False)
    mesh = scene.mesh_at(0)

    # Procedural wobble: f(vertices, t) on tensors of the scene's device.
    def wobble(vertices, t):
        bend = 0.4 * torch.sin(4.0 * vertices[:, 0] + 6.28 * t)
        return torch.stack([vertices[:, 0], vertices[:, 1] + bend, vertices[:, 2]], dim=-1)

    mesh.add_animation_func(wobble, 0.0, 1.0)

    images = render_randomized_variants(scene, kwargs)
    save_variants("06_animation", images)
