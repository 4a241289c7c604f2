"""The main path: the pattern-optimization inner loop on the vocalfold scene.

The workload of the reference's benchmark (`bench.py::measure`): build
`vocalfold(resolution=24, n_anim_frames=4)` (1440 faces), randomize one
variant per seed, attach the analytic beam-splat projector of a 12x12
laser pattern, assemble, path-trace every variant (512x512, spp 1,
2 bounces, static geometry), and differentiate the mean image with respect
to the (144, 3) beam directions.  `bench.py` also records the
reference-realistic shape: `resolution=75` (11538 faces) at spp 4 with
`coherent_bounce` and `shared_primary`, which runs on the streamed kernels.
Each shape also runs with tile culling off (`tile_cull=False`, the
reference's FF_NO_TILE_CULL=1), on the kernels without cluster lists.

    bridge, randomize, beams = build(device, resolution)
    img = render_batch(bridge, randomize, beams, seeds, cfg)      # (B, H, W, 3)
    loss, grad = pattern_step(bridge, randomize, beams, seeds, cfg)
"""

from __future__ import annotations

import torch

from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.projection import laser
from fireflies_tpu_torch.render import RenderConfig, SceneBridge, render_rgb

Tensor = torch.Tensor

PROJECTOR_FOV = 30.0
BEAM_SIGMA = 10.0
BEAM_TEXTURE = (256, 256)

# The shapes chip_smoke.py drives, by name: (vocalfold resolution,
# bench_config settings beside size).  All have 2 bounces and a batch of 16
# there.  Faces (fold + 288 tube): main 1440, the benchmark default (B1 and
# B3); mid 5288, the mid-sized route (B1 and B5); reference 11538, the
# reference-realistic shape (B2 and B4).  The `_unculled` shapes turn tile
# culling off: main_unculled on B6 and B3, reference_unculled on B7s and
# B7g with the attribute gather.
_REFERENCE = dict(spp=4, coherent_bounce=True, shared_primary=True)
SHAPES = {
    "main": (24, {}),
    "mid": (50, {}),
    "reference": (75, _REFERENCE),
    "main_unculled": (24, dict(tile_cull=False)),
    "reference_unculled": (75, dict(_REFERENCE, tile_cull=False)),
}


def bench_config(size: int = 512, spp: int = 1, bounces: int = 2, coherent_bounce: bool = False,
                 shared_primary: bool = False, tile_cull: bool = True) -> RenderConfig:
    return RenderConfig(width=size, height=size, spp=spp, max_bounces=bounces,
                        static_geometry=True, coherent_bounce=coherent_bounce,
                        shared_primary=shared_primary, tile_cull=tile_cull)


def build(device="cuda", resolution: int = SHAPES["main"][0]):
    """(bridge, randomize, beams): the vocalfold scene at `resolution`, its
    randomize function on `device` (the card unless the caller asks for the
    CPU), and the (144, 3) uniform beam pattern."""
    scene, kw = scenes.vocalfold(resolution=resolution, n_anim_frames=4)
    bridge = SceneBridge(scene, **kw)
    randomize = scene.compile(device=device)
    beams = laser.generate_uniform_rays(0.0275, 12, 12, device=device)
    return bridge, randomize, beams


def generators(seeds, device) -> list[torch.Generator]:
    """One torch.Generator per variant, seeded from an int."""
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def scene_batch(bridge: SceneBridge, randomize, beams: Tensor, gens):
    """The RenderScene of one randomized variant per generator, each with
    the beam pattern's projector attached."""
    beam_params = laser.rays_to_beam_params(beams, PROJECTOR_FOV, sigma=BEAM_SIGMA,
                                            texture_size=BEAM_TEXTURE)
    return bridge.assemble([dict(randomize(g, 0), **beam_params) for g in gens])


def render_batch(bridge: SceneBridge, randomize, beams: Tensor, seeds,
                 cfg: RenderConfig) -> Tensor:
    """Render one randomized variant per seed in one batch; (B, H, W, 3)."""
    gens = generators(seeds, beams.device)
    return render_rgb(scene_batch(bridge, randomize, beams, gens), gens, cfg)


def pattern_step(bridge: SceneBridge, randomize, beams: Tensor, seeds,
                 cfg: RenderConfig) -> tuple[Tensor, Tensor]:
    """Loss = mean over variants of the mean image, and its gradient with
    respect to the (K, 3) beam directions.  Backward runs per variant and
    accumulates, so memory holds one variant's graph at a time."""
    beams = beams.detach().requires_grad_(True)
    loss = torch.zeros((), device=beams.device)
    for seed in seeds:
        loss_i = render_batch(bridge, randomize, beams, [seed], cfg).mean() / len(seeds)
        loss_i.backward()
        loss = loss + loss_i.detach()
    return loss, beams.grad
