"""Optimization: the pattern optimizers, inverse rendering and checkpoints."""

from fireflies_tpu_torch.optim.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from fireflies_tpu_torch.optim.inverse import (
    InverseResult,
    hybrid_pose_loss,
    image_l2,
    optimize_params,
)
from fireflies_tpu_torch.optim.pattern import (
    PatternOptResult,
    RenderOptResult,
    dot_coverage_objective,
    make_variant_loss,
    optimize_pattern_through_render,
    optimize_point_pattern,
    overlap_loss,
)

__all__ = [
    "InverseResult",
    "PatternOptResult",
    "RenderOptResult",
    "dot_coverage_objective",
    "hybrid_pose_loss",
    "image_l2",
    "latest_checkpoint",
    "load_checkpoint",
    "make_variant_loss",
    "optimize_params",
    "optimize_pattern_through_render",
    "optimize_point_pattern",
    "overlap_loss",
    "save_checkpoint",
]
