"""Inverse rendering: optimize scene parameters against target images
(port of fireflies_tpu/optim/inverse.py).

`optimize_params` runs Adam over a dict of trainable tensors, the rest of
the scene closed over by the loss.  The image objectives reduce by the mean
over every element they are given, so a batch of equally sized images
gives the mean of the per-image losses.

Step i of an optimizer draws its variants from the generators
`utils.seeds.step_generators(seed, i, n)` returns.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fireflies_tpu_torch.utils.seeds import step_generators

Tensor = torch.Tensor


class InverseResult(NamedTuple):
    params: dict
    losses: Tensor  # (steps,)


def image_l2(rendered: Tensor, target: Tensor) -> Tensor:
    return ((rendered - target) ** 2).mean()


def hybrid_pose_loss(rendered: Tensor, target: Tensor, soft_mask: Tensor, target_mask: Tensor,
                     mask_weight: float = 1.0, valid_mask: Tensor | None = None) -> Tensor:
    """The pose/shape-fitting objective: the path-traced image's L2 (its
    interior gradients; with `valid_mask` only over those pixels) plus
    `mask_weight` times the soft silhouette's L2 (its boundary gradients).

    rendered/target: (..., H, W, C) images; soft_mask/target_mask:
    (..., H, W) coverage; valid_mask: (..., H, W) bool, detached.
    """
    if valid_mask is not None:
        valid = valid_mask.detach()
        n = valid.sum().clamp(min=1)
        app = torch.where(valid[..., None], (rendered - target) ** 2, 0.0).sum() / n
    else:
        app = ((rendered - target) ** 2).mean()
    sil = ((soft_mask - target_mask) ** 2).mean()
    return app + mask_weight * sil


def optimize_params(trainable_init: dict, loss_fn: Callable[[dict, list], Tensor], seed: int = 0,
                    steps: int = 100, learning_rate: float = 1e-2,
                    grad_batch: int = 1) -> InverseResult:
    """Adam (torch.optim.Adam's defaults: optax.adam's update) over a dict
    of trainable tensors.

    loss_fn(trainable, gens) -> (len(gens),) per-variant losses (or a
    scalar) closes over the scene and the render; each step passes it
    `grad_batch` generators (`step_generators(seed, step, grad_batch)` on
    the tensors' device) in one batched call and descends on the mean,
    the gradient averaged over the variants.  The losses are kept on the
    device: no host sync per step.
    """
    params = {k: v.detach().clone().requires_grad_(True) for k, v in trainable_init.items()}
    opt = torch.optim.Adam(params.values(), lr=learning_rate)
    device = next(iter(params.values())).device
    losses = []
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, step_generators(seed, step, grad_batch, device)).mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return InverseResult(params={k: v.detach() for k, v in params.items()},
                         losses=torch.stack(losses))
