"""Soft (SoftRas-style) differentiable silhouettes (port of
fireflies_tpu/render/soft.py).

The path tracer's traversal is detached, so its gradients stop at
occlusion boundaries.  This module renders a soft coverage mask instead:
each pixel's signed 2D distance to each projected triangle goes through a
sigmoid, and the faces combine by the probabilistic union (Soft
Rasterizer, Liu et al. 2019).  It is differentiable with respect to the
vertices, the camera pose and the fov, across silhouettes too.

The cost is O(B x F x H x W); faces are reduced in chunks, each under
`torch.utils.checkpoint`, so the backward recomputes a chunk's
(B, chunk, H, W) intermediates instead of storing every chunk's.  Plain
PyTorch: the reference's function is plain jnp and reaches no Pallas
kernel.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from fireflies_tpu_torch.render.rays import points_to_ndc
from fireflies_tpu_torch.render.types import RenderConfig, RenderScene

Tensor = torch.Tensor


def _edge_signed_dist(px: Tensor, py: Tensor, ax, ay, bx, by) -> Tensor:
    """Signed distance of the pixels (H, W) to the edges a -> b (B, C),
    positive on the left; (B, C, H, W)."""
    ex, ey = bx - ax, by - ay
    num = (ex[..., None, None] * (py - ay[..., None, None])
           - ey[..., None, None] * (px - ax[..., None, None]))
    inv_len = 1.0 / torch.sqrt(ex * ex + ey * ey + 1e-12)
    return num * inv_len[..., None, None]


def _chunk_not_covered(not_cov: Tensor, v0: Tensor, v1: Tensor, v2: Tensor, valid: Tensor,
                       px: Tensor, py: Tensor, sigma: float) -> Tensor:
    """not_cov (B, H, W) times the product over one face chunk (corners
    (B, C, 3) in NDC, `valid` (C,)) of 1 - coverage."""
    in_front = (v0[..., 2] > 0) & (v1[..., 2] > 0) & (v2[..., 2] > 0)
    # Orient every triangle to a positive signed area, so that the inside
    # is positive for all three edges; edge-on slivers are dropped.
    area2 = ((v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1])
             - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0]))
    flip = torch.where(area2 < 0, -1.0, 1.0)[..., None, None]
    not_degenerate = area2.abs() > 1e-7
    d0 = _edge_signed_dist(px, py, v0[..., 0], v0[..., 1], v1[..., 0], v1[..., 1]) * flip
    d1 = _edge_signed_dist(px, py, v1[..., 0], v1[..., 1], v2[..., 0], v2[..., 1]) * flip
    d2 = _edge_signed_dist(px, py, v2[..., 0], v2[..., 1], v0[..., 0], v0[..., 1]) * flip
    d_min = torch.minimum(torch.minimum(d0, d1), d2)
    cov = torch.sigmoid(torch.sign(d_min) * d_min * d_min / sigma)
    cov = torch.where((valid & in_front & not_degenerate)[..., None, None], cov, 0.0)
    return not_cov * torch.prod(1.0 - cov, dim=1)


def soft_silhouette(vertices_ndc: Tensor, faces: Tensor, height: int, width: int,
                    sigma: float = 2e-4, face_chunk: int = 64,
                    face_mask: Tensor | None = None) -> Tensor:
    """(B, H, W) soft coverage in [0, 1] from NDC-projected vertices
    (B, V, 3): x, y in [-1, 1], z the view depth (> 0 in front).  Faces with
    a vertex behind the camera are dropped, as are faces where `face_mask`
    (F,) is False.  `sigma` sets the edge softness in squared-NDC units
    (coverage = sigmoid(sign(d) d^2 / sigma))."""
    dev = vertices_ndc.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height * 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W): x right, y up
    n_faces = faces.shape[0]
    chunk = max(min(face_chunk, n_faces), 1)
    mask = (torch.ones(n_faces, dtype=torch.bool, device=dev) if face_mask is None
            else face_mask)
    not_cov = vertices_ndc.new_ones(vertices_ndc.shape[0], height, width)
    for c0 in range(0, n_faces, chunk):
        fc = faces[c0:c0 + chunk]
        corners = [vertices_ndc[:, fc[:, k]] for k in range(3)]
        not_cov = checkpoint(_chunk_not_covered, not_cov, *corners, mask[c0:c0 + chunk],
                             px, py, sigma, use_reentrant=False)
    return 1.0 - not_cov


def render_soft_silhouette(scene: RenderScene, config: RenderConfig, sigma: float = 2e-4,
                           mesh_id: int | None = None) -> Tensor:
    """(B, H, W) differentiable coverage of the scene's faces (or of mesh
    `mesh_id`'s) from each variant's camera, at config's film size."""
    geo = scene.geometry
    ndc = points_to_ndc(scene.camera, geo.vertices)
    face_mask = geo.face_mesh == mesh_id if mesh_id is not None else None
    return soft_silhouette(ndc, geo.faces, config.height, config.width, sigma=sigma,
                           face_mask=face_mask)
