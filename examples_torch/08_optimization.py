"""Inverse rendering: recover a mesh pose from target depth images.

Twin of examples/08_optimization.py: differentiate depth renders with
respect to vertex positions (detached traversal + re-derived hit) and
descend to match a target.

Two gradient regimes are demonstrated:
  1. detached-traversal depth gradients (exact in lobe interiors) recover a
     depth-axis offset;
  2. soft-silhouette gradients (render_soft_silhouette) recover a LATERAL
     offset, the direction detached traversal cannot see.
"""

import torch

from _common import device, out_dir

from fireflies_tpu_torch import optim
from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.render import (
    RenderConfig,
    SceneBridge,
    render_depth_differentiable,
    render_soft_silhouette,
)

if __name__ == "__main__":
    dev = device()
    scene, kwargs = scenes.hello_world(randomize_rotation=False)
    bridge = SceneBridge(scene, **kwargs)
    randomize = scene.compile(device=dev)
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=1, tri_chunk=128)

    base_params = randomize(torch.Generator(device=dev).manual_seed(0), 0)
    depth_axis = torch.tensor([0.0, 0.3, -1.0], device=dev)  # toward/away from the camera
    depth_axis = depth_axis / torch.linalg.vector_norm(depth_axis)

    def moved(axis, offset):
        params = dict(base_params)
        params["mesh-Cube.vertex_positions"] = (
            params["mesh-Cube.vertex_positions"] + axis[None, :] * offset
        )
        return bridge.assemble(params)

    def depth_with_offset(offset):
        return render_depth_differentiable(moved(depth_axis, offset), cfg)

    true_offset = 0.35
    with torch.no_grad():
        target = depth_with_offset(torch.tensor(true_offset, device=dev))

    def loss_fn(trainable, gens):
        d = depth_with_offset(trainable["offset"])
        # Mask to pixels where BOTH maps hit geometry: background(0)-vs-depth
        # mismatches at the silhouette carry no usable interior gradient and
        # would otherwise dominate the L2 with the wrong direction.
        both = ((d > 0) & (target > 0)).detach()
        n = both.sum().clamp(min=1)
        return torch.where(both, (d - target) ** 2, 0.0).sum() / n

    res = optim.optimize_params(
        {"offset": torch.tensor(0.0, device=dev)}, loss_fn, 0, steps=200,
        learning_rate=1e-2,
    )
    print("depth-axis recovered:", float(res.params["offset"]), "target:", true_offset)

    # --- Part 2: lateral offset via soft silhouettes -----------------------
    lateral_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)

    def sil_with_offset(offset):
        return render_soft_silhouette(moved(lateral_axis, offset), cfg, sigma=2e-4)

    true_lateral = 0.3
    with torch.no_grad():
        target_sil = sil_with_offset(torch.tensor(true_lateral, device=dev))

    def sil_loss(trainable, gens):
        return ((sil_with_offset(trainable["dx"]) - target_sil) ** 2).mean()

    res2 = optim.optimize_params(
        {"dx": torch.tensor(0.0, device=dev)}, sil_loss, 0, steps=150,
        learning_rate=2e-2,
    )
    print("lateral recovered:", float(res2.params["dx"]), "target:", true_lateral)
    (out_dir("08_optimization") / "result.txt").write_text(
        f"depth recovered={float(res.params['offset'])} target={true_offset}\n"
        f"lateral recovered={float(res2.params['dx'])} target={true_lateral}\n"
    )
