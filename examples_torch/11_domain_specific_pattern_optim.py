"""Domain-specific pattern optimization: vocalfold structured light.

Twin of examples/11_domain_specific_pattern_optim.py: optimize a 144-beam
laser pattern through the differentiable renderer on randomized vocalfold
variants, the pattern rasterized into the projector's texture.
"""

import os

import torch

from _common import device, out_dir

from fireflies_tpu_torch import optim
from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.projection import laser as laser_mod
from fireflies_tpu_torch.render import RenderConfig, SceneBridge, render_rgb
from fireflies_tpu_torch.utils.png import write_png

SIZE = int(os.environ.get("EXAMPLE_SIZE", 64))
STEPS = int(os.environ.get("EXAMPLE_STEPS", 10))

if __name__ == "__main__":
    dev = device()
    scene, kwargs = scenes.vocalfold(resolution=12, n_anim_frames=4)
    bridge = SceneBridge(scene, **kwargs)
    randomize = scene.compile(device=dev)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1, max_bounces=1, tri_chunk=256)

    def texture_fn(rays):
        tex = laser_mod.rays_to_texture_summed(rays, 30.0, 6.0, (128, 128), chunk=32)
        return torch.stack([torch.zeros_like(tex), tex, torch.zeros_like(tex)], -1)

    loss_fn = optim.make_variant_loss(
        randomize_fn=randomize,
        assemble_fn=bridge.assemble,
        render_fn=lambda s, gens: render_rgb(s, gens, cfg),
        objective=optim.dot_coverage_objective(channel=1),
        texture_fn=texture_fn,
    )

    rays0 = laser_mod.generate_uniform_rays(0.0275, 12, 12, device=dev)  # 144 beams
    res = optim.optimize_pattern_through_render(
        loss_fn, rays0, 0, steps=STEPS, batch=2,
        learning_rate=2e-3, fov_deg=30.0,
    )
    print(f"objective {float(res.losses[0]):.4f} -> {float(res.losses[-1]):.4f}")

    d = out_dir("11_domain_specific_pattern_optim")
    with torch.no_grad():
        write_png(str(d / "pattern_before.png"), texture_fn(rays0).cpu().numpy())
        write_png(str(d / "pattern_after.png"), texture_fn(res.rays).cpu().numpy())
        gen = torch.Generator(device=dev).manual_seed(5)
        params = dict(randomize(gen, 0), **{"tex.data": texture_fn(res.rays)})
        img = render_rgb(bridge.assemble(params), [gen], cfg)[0]
    write_png(str(d / "render_with_pattern.png"), img.clamp(0, 1).cpu().numpy())
    print("wrote results to", d)
