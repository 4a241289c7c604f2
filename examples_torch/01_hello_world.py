"""Hello world: one cube, camera, light; randomize() -> render loop.

Twin of examples/01_hello_world.py.
"""

from _common import render_randomized_variants, save_variants

from fireflies_tpu_torch.assets import scenes

if __name__ == "__main__":
    scene, kwargs = scenes.hello_world()
    # hello_world() already randomizes the cube's rotation, rotate_z(-pi, pi).
    images = render_randomized_variants(scene, kwargs)
    save_variants("01_hello_world", images)
