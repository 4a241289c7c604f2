"""The full vocalfold structured-light scene + dataset mini-run.

Twin of examples/vocalfold_scene.py: randomize -> render -> segment ->
post-process -> reject -> save, a batch of frames a dispatch.
"""

import os

import torch

from _common import device, out_dir

from fireflies_tpu_torch import datagen, postprocessing as pp, sampling
from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.projection import laser as laser_mod
from fireflies_tpu_torch.render import RenderConfig, SceneBridge, render_rgb, render_segmentation

SIZE = int(os.environ.get("EXAMPLE_SIZE", 64))
N_FRAMES = int(os.environ.get("EXAMPLE_FRAMES", 8))

if __name__ == "__main__":
    dev = device()
    scene, kwargs = scenes.vocalfold(resolution=16, n_anim_frames=4)

    # The reference main loop's randomization.
    vf = scene.mesh("mesh-Vocalfold")
    vf.scale_x(1.0, 1.5)
    vf.scale_z(1.0, 1.5)
    vf.rotate_y(-0.2, 0.2)
    mat = scene.material("mat-Mucosa")
    for k in ("clearcoat", "roughness", "sheen"):
        mat.add_float_key(k, 0.0, 1.0)
    light = scene.light("emit-Spot")
    light.add_vec3_sampler(
        "intensity.value", sampling.UniformScalarToVec3Sampler.create(5.0, 25.0)
    )

    bridge = SceneBridge(scene, **kwargs)
    randomize = scene.compile(device=dev)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=2, max_bounces=2, tri_chunk=256)

    rays = laser_mod.generate_uniform_rays(0.0275, 12, 12, device=dev)
    tex = laser_mod.rays_to_texture_summed(rays, 30.0, 6.0, (128, 128))
    tex_rgb = torch.stack([torch.zeros_like(tex), tex, torch.zeros_like(tex)], -1)

    pipeline = pp.PostProcessor(
        [pp.GaussianBlur((3, 3), (5.0, 5.0), 0.5), pp.ApplySilhouette(), pp.WhiteNoise(0.0, 0.05, 0.5)]
    )

    def render_batch(seeds, steps):
        """Frame i from a generator seeded seeds[i], randomized at steps[i];
        the generator then draws its render and its post-processing."""
        with torch.no_grad():
            gens = [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]
            params = [dict(randomize(g, int(s)), **{"tex.data": tex_rgb})
                      for g, s in zip(gens, steps)]
            rs = bridge.assemble(params)
            imgs = datagen.tonemap(render_rgb(rs, gens, cfg), exposure=2.0)
            imgs = torch.stack([pipeline.post_process(g, datagen.to_grayscale(img))
                                for g, img in zip(gens, imgs)])
            return imgs, render_segmentation(rs, cfg)

    n = datagen.generate_dataset(
        render_batch,
        n_frames=N_FRAMES,
        out_dir=out_dir("vocalfold_dataset"),
        seed=0,
        batch=4,
        rejection=datagen.RejectionConfig(min_coverage=0.01, max_components=3, target_mesh_id=1),
    )
    print(f"dataset frames written: {n}")
