"""Light randomization + parent-child: light orbits with the mesh.

Twin of examples/05_light_randomization.py.
"""

from _common import render_randomized_variants, save_variants

from fireflies_tpu_torch import sampling
from fireflies_tpu_torch.assets import scenes

if __name__ == "__main__":
    scene, kwargs = scenes.hello_world()
    light = scene.light_at(0)
    # Correlated grey-scale intensity.
    light.add_vec3_sampler(
        "intensity.value", sampling.UniformScalarToVec3Sampler.create(2.0, 25.0)
    )
    light.translate_x(-1.0, 1.0)
    light.translate_y(-0.5, 1.0)
    # Parent the light to the cube: it follows the mesh's randomized pose.
    light.set_parent(scene.mesh_at(0))

    images = render_randomized_variants(scene, kwargs)
    save_variants("05_light_randomization", images)
