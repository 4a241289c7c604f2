"""Material randomization: principled-BSDF float/vec3 keys.

Twin of examples/04_material_randomization.py.
"""

from _common import render_randomized_variants, save_variants

from fireflies_tpu_torch.assets import scenes

if __name__ == "__main__":
    scene, kwargs = scenes.hello_world()
    mat = scene.material("mat-Cube")
    mat.add_vec3_key("base_color", [0.1, 0.1, 0.1], [0.9, 0.9, 0.9])
    mat.add_float_key("roughness", 0.05, 1.0)
    mat.add_float_key("metallic", 0.0, 1.0)
    mat.add_float_key("specular", 0.0, 1.0)
    mat.add_float_key("clearcoat", 0.0, 1.0)

    images = render_randomized_variants(scene, kwargs, spp=4)
    save_variants("04_material_randomization", images)
