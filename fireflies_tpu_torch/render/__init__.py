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
from fireflies_tpu_torch.render.intersect import (
    closest_hit,
    hit_attributes,
    intersect_brute,
    occluded,
    occluded_any,
)
from fireflies_tpu_torch.render.pathtracer import render_rgb, trace_rays
from fireflies_tpu_torch.render.rays import camera_rays, points_to_ndc, rays_from_ndc
from fireflies_tpu_torch.render.reparam import render_depth_reparam, reparam_ndc
from fireflies_tpu_torch.render.soft import render_soft_silhouette, soft_silhouette
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
    "closest_hit",
    "intersect_brute",
    "occluded_any",
    "occluded",
    "hit_attributes",
    "camera_rays",
    "points_to_ndc",
    "rays_from_ndc",
    "render_soft_silhouette",
    "soft_silhouette",
    "Camera",
    "Geometry",
    "Hit",
    "Lights",
    "Materials",
    "Projector",
    "RenderConfig",
    "RenderScene",
]
