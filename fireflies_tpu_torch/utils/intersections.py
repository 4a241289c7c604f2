"""Geometric intersection predicates (port of
fireflies_tpu/utils/intersections.py): rays against planes and boxes,
spheres against spheres.  Inputs broadcast over leading axes."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def ray_plane(ray_origin: Tensor, ray_direction: Tensor, plane_origin: Tensor,
              plane_normal: Tensor, eps: float = 1e-6) -> Tensor:
    """(..., 3) points where the rays meet the plane.  A ray (nearly)
    parallel to it divides by +-eps (`ray_plane_t`)."""
    t = ray_plane_t(ray_origin, ray_direction, plane_origin, plane_normal, eps)
    return ray_origin + t[..., None] * ray_direction


def ray_plane_t(ray_origin: Tensor, ray_direction: Tensor, plane_origin: Tensor,
                plane_normal: Tensor, eps: float = 1e-6) -> Tensor:
    """(...,) ray parameter of the ray/plane intersection; a denominator
    below eps in magnitude is clamped to +-eps, keeping its sign."""
    denom = (ray_direction * plane_normal).sum(dim=-1)
    denom = torch.where(denom.abs() < eps, torch.where(denom < 0, -eps, eps), denom)
    return ((plane_origin - ray_origin) * plane_normal).sum(dim=-1) / denom


def sphere_sphere(center_a: Tensor, radius_a, center_b: Tensor, radius_b) -> Tensor:
    """True where the two spheres touch or overlap."""
    dist = torch.linalg.vector_norm(center_a - center_b, dim=-1)
    return dist <= (radius_a + radius_b)


def ray_aabb(ray_origin: Tensor, inv_direction: Tensor, box_min: Tensor, box_max: Tensor,
             t_min=0.0, t_max=float("inf")):
    """Slab test: (hit, t_near).  `inv_direction` = 1 / d, infinities
    allowed (the IEEE slab test handles them)."""
    t0 = (box_min - ray_origin) * inv_direction
    t1 = (box_max - ray_origin) * inv_direction
    t_near = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), t_min)
    t_far = torch.clamp_max(torch.maximum(t0, t1).amin(dim=-1), t_max)
    return t_near <= t_far, t_near
