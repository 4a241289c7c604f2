"""Gradient-based pattern optimization (port of fireflies_tpu/optim/pattern.py).

Two workloads:

  * overlap-regularized 2D point optimization: minimize
    L1(softor(points), sum(points)), which is zero iff no two splats
    overlap; Adam on the point coordinates, clamped to [0, 1]^2 each step;
  * laser beam directions optimized through the differentiable renderer
    against an image objective, the gradient averaged over a batch of
    randomized scene variants each step.

The reference vmaps a one-variant loss over the batch.  Here the scene
carries a leading variant axis instead, so `make_variant_loss` builds one
batched loss(rays, gens, step) -> (B,) that randomizes, assembles and
renders every variant at once, and objectives reduce each image on its own
(B, H, W, C) -> (B,) before the optimizer takes the mean.  Adam is
torch.optim.Adam with its defaults, optax.adam's update; steps draw from
`utils.seeds.step_generators`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from fireflies_tpu_torch.graphics import rasterization
from fireflies_tpu_torch.projection import laser as laser_mod
from fireflies_tpu_torch.utils.seeds import step_generators

Tensor = torch.Tensor


def overlap_loss(points: Tensor, sigma: float, texture_size, chunk: int = 64) -> Tensor:
    """L1 between the soft-or and the sum of the points' splats: zero iff
    no two splats overlap."""
    summed = rasterization.sum_points(points, sigma, texture_size, chunk=chunk)
    softored = rasterization.softor_points(points, sigma, texture_size, chunk=chunk)
    return (softored - summed).abs().mean()


class PatternOptResult(NamedTuple):
    points: Tensor
    losses: Tensor  # (steps,)


def optimize_point_pattern(seed: int = 0, n_points: int = 500, sigma: float = 225.0,
                           texture_size=(512, 512), steps: int = 200,
                           learning_rate: float = 1e-3, init_points: Optional[Tensor] = None,
                           chunk: int = 64, device="cuda") -> PatternOptResult:
    """Adam on point coordinates against `overlap_loss`, clamped to [0, 1]
    after each step.  Defaults are the reference workload's shape (500
    points, 512^2, 200 steps, lr 1e-3, sigma 15^2).  Without `init_points`
    the points start uniform in [0, 1)^2, drawn from a generator seeded
    `seed` on `device` (the card unless the caller asks for the CPU); with
    them the run is on their device."""
    if init_points is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        init_points = torch.rand((n_points, 2), generator=gen, device=device)
    points = init_points.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([points], lr=learning_rate)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = overlap_loss(points, sigma, texture_size, chunk=chunk)
        loss.backward()
        opt.step()
        with torch.no_grad():
            points.clamp_(0.0, 1.0)
        losses.append(loss.detach())
    return PatternOptResult(points=points.detach(), losses=torch.stack(losses))


class RenderOptResult(NamedTuple):
    rays: Tensor
    losses: Tensor  # (steps,)


def make_variant_loss(randomize_fn: Callable, assemble_fn: Callable, render_fn: Callable,
                      objective: Callable[[Tensor, dict], Tensor],
                      texture_fn: Callable[[Tensor], Tensor] | None = None,
                      pattern_params_fn: Callable[[Tensor], dict] | None = None):
    """Compose randomize -> assemble (+ pattern) -> render -> objective into
    loss(rays, gens, step) -> (B,), one loss per generator's variant.

    randomize_fn(gen, step) -> param dict of one variant; assemble_fn(list
    of param dicts) -> batched RenderScene; render_fn(scene, gens) ->
    (B, H, W, 3); objective(images, aux) -> (B,), reducing each image on
    its own, with aux {"params": the variants' dicts, "scene": the scene}.

    Pattern injection, exactly one of:
      texture_fn: rays (K, 3) -> (H, W, 3) projector texture ("tex.data");
      pattern_params_fn: rays (K, 3) -> {param_key: value} entries merged
        into every variant's params (laser.rays_to_beam_params, the
        analytic beam projector).
    """
    if (texture_fn is None) == (pattern_params_fn is None):
        raise ValueError("pass exactly one of texture_fn / pattern_params_fn")

    def loss(rays: Tensor, gens, step: int) -> Tensor:
        pattern = ({"tex.data": texture_fn(rays)} if texture_fn is not None
                   else pattern_params_fn(rays))
        params = [dict(randomize_fn(g, step), **pattern) for g in gens]
        scene = assemble_fn(params)
        img = render_fn(scene, gens)
        return objective(img, {"params": params, "scene": scene})

    return loss


def optimize_pattern_through_render(loss_fn: Callable[[Tensor, list, int], Tensor],
                                    init_rays: Tensor, seed: int = 0, steps: int = 100,
                                    batch: int = 4, learning_rate: float = 5e-3,
                                    fov_deg: float = 30.0,
                                    respawn_oob: bool = True) -> RenderOptResult:
    """Adam on laser beam directions, the gradient averaged over `batch`
    randomized variants a step: step i calls loss_fn(rays, gens, i) once
    with the first `batch` generators of `step_generators(seed, i, batch +
    1)` and descends on the mean.  After each update the beams are
    re-normalized and, with `respawn_oob`, beams outside the projector's
    NDC square respawned from the last generator.  The update is in place,
    so both run under no_grad on the parameter itself.  The losses stay on
    the device: no host sync per step."""
    rays = init_rays.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([rays], lr=learning_rate)
    losses = []
    for step in range(steps):
        gens = step_generators(seed, step, batch + 1, rays.device)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(rays, gens[:batch], step).mean()
        loss.backward()
        opt.step()
        with torch.no_grad():
            rays.div_(torch.linalg.vector_norm(rays, dim=-1, keepdim=True) + 1e-20)
            if respawn_oob:
                rays.copy_(laser_mod.respawn_out_of_bounds(gens[batch], rays, fov_deg))
        losses.append(loss.detach())
    return RenderOptResult(rays=rays.detach(), losses=torch.stack(losses))


def dot_coverage_objective(channel: int = 1) -> Callable:
    """Maximize detected laser-dot energy spread: bright, well-separated
    dots in each camera image (negated for minimization).  Images
    (..., H, W, C) -> losses (...), each image reduced on its own, since
    the loss is nonlinear in its total and peak."""

    def objective(img: Tensor, aux: dict | None = None) -> Tensor:
        x = img[..., channel]
        total = x.sum(dim=(-2, -1))
        # A high peak relative to the total means dots collapsed together.
        peak = x.amax(dim=(-2, -1))
        return -(total - 0.5 * peak * torch.sqrt(total + 1e-6))

    return objective
