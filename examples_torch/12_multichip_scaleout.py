"""Scale-out: variant-parallel rendering + gradient-averaged pattern steps.

Twin of examples/12_multichip_scaleout.py.  Every rank of a
torch.distributed process group renders its share of the randomized
variants, and the distributed pattern-optimization step averages the
gradients over the ranks (parallel.psum_grad_step).  Started alone the
script makes its own one-rank group (NCCL on the card, gloo on the CPU);
under torchrun each process takes its rank from the environment, e.g. on
the CPU in four gloo processes:

  FIREFLIES_DEVICE=cpu torchrun --nproc_per_node 4 examples_torch/12_multichip_scaleout.py
"""

import os
import tempfile

import torch
import torch.distributed as dist

from _common import device, save_variants

from fireflies_tpu_torch import parallel
from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.datagen import tonemap
from fireflies_tpu_torch.projection import laser as laser_mod
from fireflies_tpu_torch.render import RenderConfig, SceneBridge, render_rgb

SIZE = int(os.environ.get("EXAMPLE_SIZE", 48))
PER_DEVICE = int(os.environ.get("EXAMPLE_PER_DEVICE", 2))


def start_group(dev: torch.device, tmp: str) -> torch.device:
    """This process's group: torchrun's rank, world size and address when
    it set them (each rank on its own card), else a group of one rank
    through a FileStore in `tmp`.  Returns this rank's device."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        parallel.init_distributed(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), dev,
                                  init_method="env://")
    else:
        parallel.init_distributed(0, 1, dev, store_path=os.path.join(tmp, "store"))
    return dev


def main(dev: torch.device) -> None:
    mesh = parallel.make_mesh(device=dev)
    n_dev = mesh.shape[parallel.DATA_AXIS]
    rank = mesh.coords[parallel.DATA_AXIS]
    print(f"device mesh: {n_dev} x {parallel.DATA_AXIS}")

    scene, kwargs = scenes.vocalfold(resolution=12, n_anim_frames=4)
    bridge = SceneBridge(scene, **kwargs)
    randomize = scene.compile(device=dev)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1, max_bounces=2, tri_chunk=256)

    rays0 = laser_mod.generate_uniform_rays(0.0275, 8, 8, device=dev)

    def texture(r):
        t = laser_mod.rays_to_texture_summed(r, 30.0, 6.0, (96, 96), chunk=32)
        return torch.stack([torch.zeros_like(t), t, torch.zeros_like(t)], -1)

    # ---- 1. Variant-parallel rendering (dataset farming across the ranks) --
    def render_batch(gens, steps):
        with torch.no_grad():
            tex = texture(rays0)
            params = [dict(randomize(g, s), **{"tex.data": tex}) for g, s in zip(gens, steps)]
            return tonemap(render_rgb(bridge.assemble(params), gens, cfg), exposure=2.0)

    run = parallel.variant_parallel(render_batch, mesh)
    gens = parallel.shard_keys(mesh, 0, PER_DEVICE)
    steps = [rank * PER_DEVICE + i for i in range(PER_DEVICE)]
    frames = run(gens, steps)
    print(f"rendered {frames.shape[0]} variants across {n_dev} devices:", tuple(frames.shape))
    if rank == 0:
        save_variants("12_multichip_scaleout", frames[: min(4, len(frames))])

    # ---- 2. Distributed pattern-optimization step (averaged gradients) -----
    def loss_fn(params, gens):
        tex = texture(params["rays"])
        p = [dict(randomize(g, 0), **{"tex.data": tex}) for g in gens]
        img = render_rgb(bridge.assemble(p), gens, cfg)
        return -img[..., 1].mean(dim=(1, 2))

    step = parallel.psum_grad_step(loss_fn, mesh)
    loss, grad = step({"rays": rays0}, parallel.shard_keys(mesh, 1, PER_DEVICE))
    gnorm = float(torch.linalg.vector_norm(grad["rays"]))
    print(f"psum step: loss={float(loss):.5f} grad_norm={gnorm:.3e} "
          f"(gradients averaged over {n_dev * PER_DEVICE} variants on {n_dev} devices)")


if __name__ == "__main__":
    dev = device()
    own_group = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if own_group:
            dev = start_group(dev, tmp)
        try:
            main(dev)
        finally:
            if own_group:
                dist.destroy_process_group()
