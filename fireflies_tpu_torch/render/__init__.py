"""Renderer: scene bridge, data model and path tracer."""

from fireflies_tpu_torch.render.bridge import SceneBridge
from fireflies_tpu_torch.render.integrators import (
    random_depth_maps,
    render_depth,
    render_depth_differentiable,
    render_from_laser,
    render_segmentation,
    render_shape_index,
)
from fireflies_tpu_torch.render.pathtracer import render_rgb, trace_rays
from fireflies_tpu_torch.render.reparam import render_depth_reparam, reparam_ndc
from fireflies_tpu_torch.render.types import (
    Camera,
    Geometry,
    Hit,
    Lights,
    Materials,
    Projector,
    RenderConfig,
    RenderScene,
)

__all__ = [
    "SceneBridge",
    "render_rgb",
    "render_depth",
    "render_depth_differentiable",
    "render_segmentation",
    "render_shape_index",
    "render_from_laser",
    "random_depth_maps",
    "render_depth_reparam",
    "reparam_ndc",
    "trace_rays",
    "Camera",
    "Geometry",
    "Hit",
    "Lights",
    "Materials",
    "Projector",
    "RenderConfig",
    "RenderScene",
]
