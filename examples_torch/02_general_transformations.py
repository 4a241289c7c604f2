"""All entity transforms: rotate/translate/scale intervals on a mesh.

Twin of examples/02_general_transformations.py.
"""

from _common import render_randomized_variants, save_variants

from fireflies_tpu_torch.assets import scenes

if __name__ == "__main__":
    scene, kwargs = scenes.hello_world(randomize_rotation=False)
    mesh = scene.mesh_at(0)

    # Rotations (per-axis and full-vector interval).
    mesh.rotate_x(-0.5, 0.5)
    mesh.rotate_y(-0.5, 0.5)
    mesh.rotate_z(-0.5, 0.5)
    mesh.rotate([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])

    # Translations.
    mesh.translate_x(-0.5, 0.5)
    mesh.translate_y(-0.25, 0.25)
    mesh.translate_z(-0.5, 0.5)

    # Scales (meshes only).
    mesh.scale_x(0.5, 2.0)
    mesh.scale_y(0.5, 2.0)
    mesh.scale_z(0.5, 2.0)

    images = render_randomized_variants(scene, kwargs)
    save_variants("02_general_transformations", images)
