"""Gradient accumulation across randomized variants.

Twin of examples/07_gradient_accumulation.py: average the gradient of a
render loss over a batch of randomized scene variants, the batch rendered
in one call (the scene tensors carry a variant axis).  Across cards,
parallel.psum_grad_step averages it over the ranks (example 12).
"""

import torch

from _common import device, out_dir

from fireflies_tpu_torch import optim
from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.render import RenderConfig, SceneBridge, render_rgb

if __name__ == "__main__":
    dev = device()
    scene, kwargs = scenes.hello_world()
    bridge = SceneBridge(scene, **kwargs)
    randomize = scene.compile(device=dev)
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2, tri_chunk=128)

    # Optimize the light intensity so the mean image brightness hits 0.25,
    # with gradients accumulated over 8 randomized variants per step.
    def loss_fn(trainable, gens):
        params = [dict(randomize(g, 0), **{"light-Point.intensity": trainable["intensity"]})
                  for g in gens]
        img = render_rgb(bridge.assemble(params), gens, cfg)
        return (img.mean(dim=(1, 2, 3)) - 0.25) ** 2

    res = optim.optimize_params(
        {"intensity": torch.full((3,), 5.0, device=dev)},
        loss_fn,
        0,
        steps=30,
        learning_rate=0.5,
        grad_batch=8,
    )
    intensity = res.params["intensity"].cpu().numpy()
    print("final loss:", float(res.losses[-1]))
    print("optimized intensity:", intensity)
    (out_dir("07_gradient_accumulation") / "result.txt").write_text(
        f"loss={float(res.losses[-1])}\nintensity={intensity}\n"
    )
