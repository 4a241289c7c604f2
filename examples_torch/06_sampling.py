"""Custom samplers: gaussian scale sampler on a mesh.

Twin of examples/06_sampling.py.
"""

import numpy as np

from _common import render_randomized_variants, save_variants

from fireflies_tpu_torch import sampling
from fireflies_tpu_torch.assets import scenes

if __name__ == "__main__":
    scene, kwargs = scenes.hello_world()
    mesh = scene.mesh_at(0)
    mesh.set_scale_sampler(
        sampling.GaussianSampler.create(np.ones(3), np.full(3, 0.25))
    )

    images = render_randomized_variants(scene, kwargs)
    save_variants("06_sampling", images)
