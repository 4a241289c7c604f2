"""Renderer: scene bridge, data model and path tracer."""

from fireflies_tpu_torch.render.bridge import SceneBridge
from fireflies_tpu_torch.render.pathtracer import render_rgb, trace_rays
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
