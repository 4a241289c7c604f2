"""Image objectives for inverse rendering (port of the loss functions of
fireflies_tpu/optim/inverse.py; `optimize_params` is not ported yet).

Each reduces by the mean over every element it is given, so a batch of
equally sized images gives the mean of the per-image losses.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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
