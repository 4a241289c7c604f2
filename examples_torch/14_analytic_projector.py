"""Analytic beam-splat projector: the fast path for pattern optimization.

Twin of examples/14_analytic_projector.py.  The texture route (example 11)
rasterizes the beam pattern to a projector texture each step and the
renderer looks it up at every NEE vertex.  Beam mode instead evaluates the
same continuous Gaussian splat field analytically at each shading point's
projector-NDC coordinates (render/lights.py), so the pattern is
differentiable directly with respect to the beam directions, with no
texture in the loop.

`build(dev)` returns the objective and the starting pattern; the optimized
pattern is saved as rays.npy beside the images, so that the objective of
both patterns can be compared on other variants (chip_smoke.py does).
"""

import os

import numpy as np
import torch

from _common import device, out_dir

from fireflies_tpu_torch import optim
from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.projection import laser as laser_mod
from fireflies_tpu_torch.render import RenderConfig, SceneBridge, render_rgb
from fireflies_tpu_torch.utils.png import write_png

SIZE = int(os.environ.get("EXAMPLE_SIZE", 64))
STEPS = int(os.environ.get("EXAMPLE_STEPS", 10))


def beam_params_fn(rays):
    # Same sigma/extent as the texture route would rasterize; the emitter
    # evaluates the splat field analytically instead.
    return laser_mod.rays_to_beam_params(rays, 30.0, sigma=6.0, texture_size=(128, 128))


def build(dev):
    """(loss_fn(rays, gens, step) -> (B,), the 144-beam uniform starting
    pattern, bridge, randomize, cfg) on `dev`."""
    scene, kwargs = scenes.vocalfold(resolution=12, n_anim_frames=4)
    bridge = SceneBridge(scene, **kwargs)
    randomize = scene.compile(device=dev)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1, max_bounces=1, tri_chunk=256)
    loss_fn = optim.make_variant_loss(
        randomize_fn=randomize,
        assemble_fn=bridge.assemble,
        render_fn=lambda s, gens: render_rgb(s, gens, cfg),
        objective=optim.dot_coverage_objective(channel=1),
        pattern_params_fn=beam_params_fn,
    )
    rays0 = laser_mod.generate_uniform_rays(0.0275, 12, 12, device=dev)  # 144 beams
    return loss_fn, rays0, bridge, randomize, cfg


def main():
    dev = device()
    loss_fn, rays0, bridge, randomize, cfg = build(dev)
    res = optim.optimize_pattern_through_render(
        loss_fn, rays0, 0, steps=STEPS, batch=2,
        learning_rate=2e-3, fov_deg=30.0,
    )
    print(f"objective {float(res.losses[0]):.4f} -> {float(res.losses[-1]):.4f}")

    d = out_dir("14_analytic_projector")

    def splat_image(rays):
        tex = laser_mod.rays_to_texture_summed(rays, 30.0, 6.0, (128, 128), chunk=32)
        return torch.stack([torch.zeros_like(tex), tex, torch.zeros_like(tex)], -1)

    with torch.no_grad():
        write_png(str(d / "pattern_before.png"), splat_image(rays0).cpu().numpy())
        write_png(str(d / "pattern_after.png"), splat_image(res.rays).cpu().numpy())
        gen = torch.Generator(device=dev).manual_seed(5)
        params = dict(randomize(gen, 0), **beam_params_fn(res.rays))
        img = render_rgb(bridge.assemble(params), [gen], cfg)[0]
    write_png(str(d / "render_with_pattern.png"), img.clamp(0, 1).cpu().numpy())
    np.save(d / "rays.npy", res.rays.detach().cpu().numpy())
    print("wrote results to", d)


if __name__ == "__main__":
    main()
