"""Warped-area visibility gradients: pose recovery from a DEPTH-ONLY loss.

Twin of examples/13_warped_area_gradients.py, the discriminating demo for
render/reparam.py: recover a lateral offset of an object whose interior
depth never changes.  The whole learning signal is the silhouette boundary
flux, which the detached path tracer reports as exactly zero (the quantity
example 08 needed a soft-silhouette mask for).  Here no mask is used:
`render_depth_reparam` alone carries the gradient.  Adam is
torch.optim.Adam at the JAX script's learning rate and step count.

Outputs: target depth, initial depth, recovered depth + convergence log.
"""

import numpy as np
import torch

from _common import SIZE, device, out_dir

from fireflies_tpu_torch.render import RenderConfig, render_depth_reparam
from fireflies_tpu_torch.render.types import (
    Camera,
    Geometry,
    Lights,
    Materials,
    RenderScene,
)
from fireflies_tpu_torch.utils.png import write_png
from fireflies_tpu_torch.utils.seeds import step_generators

RES = min(SIZE, 96)
STEPS = 120


def make_scene(dx, dev):
    """A unit quad at z = -2 moved dx along x, seen by a 60-degree camera
    at the origin; one default material, no lights."""
    half, z = 0.5, -2.0
    verts = torch.tensor(
        [[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
        device=dev,
    ) + torch.stack([dx, torch.zeros_like(dx), torch.zeros_like(dx)])[None, :]
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]], device=dev)
    geo = Geometry(
        vertices=verts[None],
        faces=faces,
        face_mat=torch.zeros(2, dtype=torch.long, device=dev),
        face_mesh=torch.zeros(2, dtype=torch.long, device=dev),
    )
    return RenderScene(
        geometry=geo,
        materials=Materials.default(1, device=dev),
        lights=Lights.empty(device=dev),
        camera=Camera.create(torch.eye(4, device=dev), fov=60.0),
    )


def generator(seed, dev):
    return [torch.Generator(device=dev).manual_seed(seed)]


def main():
    dev = device()
    cfg = RenderConfig(width=RES, height=RES, tri_chunk=16)
    target_dx = 0.3
    with torch.no_grad():
        target = render_depth_reparam(make_scene(torch.tensor(target_dx, device=dev), dev), cfg,
                                      generator(99, dev))

    dx = torch.zeros((), device=dev, requires_grad=True)
    opt = torch.optim.Adam([dx], lr=3e-2)

    d = out_dir("13_warped_area_gradients")
    with torch.no_grad():
        init_depth = render_depth_reparam(make_scene(dx, dev), cfg, generator(0, dev))

    for i in range(STEPS):
        opt.zero_grad(set_to_none=True)
        depth = render_depth_reparam(make_scene(dx, dev), cfg, step_generators(0, i, 1, dev),
                                     k_aux=8, radius=0.08)
        loss = ((depth - target) ** 2).mean()
        loss.backward()
        g = float(dx.grad)
        opt.step()
        if i % 20 == 0 or i == STEPS - 1:
            print(f"step {i:3d}  dx={dx.item():+.4f}  loss={loss.item():.3e}  "
                  f"grad={g:+.3e}")

    with torch.no_grad():
        final_depth = render_depth_reparam(make_scene(dx, dev), cfg, generator(1, dev))

    def to_img(depth):
        depth = depth[0].cpu().numpy()
        lo, hi = depth[depth > 0].min() if (depth > 0).any() else 0.0, depth.max()
        norm = np.where(depth > 0, (depth - lo) / max(hi - lo, 1e-6) * 0.7 + 0.3, 0.0)
        return np.repeat(norm[..., None], 3, axis=-1).astype(np.float32)

    write_png(str(d / "target.png"), to_img(target))
    write_png(str(d / "initial.png"), to_img(init_depth))
    write_png(str(d / "recovered.png"), to_img(final_depth))

    err = abs(dx.item() - target_dx)
    print(f"[13] recovered dx={dx.item():+.4f} (target {target_dx:+.4f}, "
          f"err {err:.4f}); depth-only loss, no silhouette mask")
    assert err < 0.03, "warped-area gradients failed to recover the offset"
    print(f"[13] wrote target/initial/recovered depth to {d}")


if __name__ == "__main__":
    main()
