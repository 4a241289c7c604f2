"""Renderer data model (port of fireflies_tpu/render/types.py).

Dataclasses of tensors with a leading variant axis B: every per-variant
field carries it (vertices (B, V, 3), camera to_world (B, 4, 4), material
rows (B, M), ...), while static topology and tables shared by every variant
(faces, face_mat, light kinds) do not.  `SceneBridge.assemble` builds these
from one randomized param dict per variant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor

LIGHT_POINT = 0
LIGHT_SPOT = 1


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Camera(_Replace):
    """Perspective sensor: camera-to-world pose, x-fov (degrees), clips.
    Camera space looks down -Z, +Y up, square pixels."""

    to_world: Tensor  # (B, 4, 4)
    fov: Tensor  # (B,) degrees, horizontal
    near: Tensor  # (B,)
    far: Tensor  # (B,)


@dataclasses.dataclass
class Projector(_Replace):
    """Textured spotlight — the structured-light source, in one of two modes.

    Texture mode (`beams_ndc` None): `texture` is an (H, W, 3) image shared
    by the batch or a (B, H, W, 3) one a variant, looked up bilinearly at
    each shading point's projector uv (u right, v up).  Analytic beam mode:
    `beams_ndc` (B, K, 2) projector-NDC beam coordinates evaluated as the
    continuous Gaussian splat field at each shading point, `beam_sigma` (B,)
    in squared-pixel units of the static `beam_hw` (H, W), and `beam_color`
    (B, 3); `texture` is None.
    """

    to_world: Tensor  # (B, 4, 4)
    fov: Tensor  # (B,)
    near: Tensor
    far: Tensor
    texture: Optional[Tensor]  # (H, W, 3) or (B, H, W, 3); None in beam mode
    scale: Tensor  # (B,)
    aperture: Optional[Tensor] = None  # not ported: must be None
    beams_ndc: Optional[Tensor] = None
    beam_sigma: Optional[Tensor] = None
    beam_color: Optional[Tensor] = None
    beam_hw: Optional[tuple] = None


@dataclasses.dataclass
class Lights(_Replace):
    """Fixed-slot delta-light table (point / spot).  Spot falloff: full
    intensity inside `beam_cos`, linear in cosine to `cutoff_cos`."""

    kinds: tuple  # (L,) python ints, static
    to_world: Tensor  # (B, L, 4, 4)
    intensity: Tensor  # (B, L, 3)
    cutoff_cos: Tensor  # (B, L)
    beam_cos: Tensor  # (B, L)
    active: Tensor  # (B, L) bool
    radius: Optional[Tensor] = None  # soft-shadow apertures: not ported

    @property
    def count(self) -> int:
        return len(self.kinds)


@dataclasses.dataclass
class Materials(_Replace):
    """Principled-BSDF parameter table, one row per material: (B, M) scalars,
    (B, M, 3) colours.  `flags` is the scene-static set of optional lobes any
    material can activate (None = all)."""

    base_color: Tensor
    roughness: Tensor
    metallic: Tensor
    specular: Tensor
    spec_tint: Tensor
    clearcoat: Tensor
    clearcoat_gloss: Tensor
    sheen: Tensor
    sheen_tint: Tensor
    anisotropic: Tensor
    spec_trans: Tensor
    flatness: Tensor
    ior: Tensor
    thin: Tensor
    emission: Tensor
    flags: Optional[frozenset] = None


@dataclasses.dataclass
class Geometry(_Replace):
    """Triangle soup: world-space vertices per variant over a static
    topology with per-face material / mesh ids."""

    vertices: Tensor  # (B, V, 3)
    faces: Tensor  # (F, 3) int64
    face_mat: Tensor  # (F,) int64
    face_mesh: Tensor  # (F,) int64
    emissive_faces: Optional[Tensor] = None  # area lights: not ported
    normals: Optional[Tensor] = None  # smooth shading: not ported

    def triangle_corners(self):
        """(v0, e1, e2), each (B, F, 3), for Möller-Trumbore."""
        v0 = self.vertices[:, self.faces[:, 0]]
        v1 = self.vertices[:, self.faces[:, 1]]
        v2 = self.vertices[:, self.faces[:, 2]]
        return v0, v1 - v0, v2 - v0


@dataclasses.dataclass
class RenderScene(_Replace):
    geometry: Geometry
    materials: Materials
    lights: Lights
    camera: Camera
    projector: Optional[Projector] = None
    # (3,) constant escape radiance; envmaps are not ported.
    background: Optional[Tensor] = None

    @property
    def batch(self) -> int:
        return self.geometry.vertices.shape[0]


@dataclasses.dataclass
class Hit(_Replace):
    """Intersection result (detached traversal output), (B, N) per field.
    nx/ny/nz/mat: the hit face's unnormalized plane normal and material id
    (see RenderConfig.static_geometry)."""

    t: Tensor
    prim: Tensor  # int32, -1 on miss
    u: Tensor
    v: Tensor
    valid: Tensor
    nx: Optional[Tensor] = None
    ny: Optional[Tensor] = None
    nz: Optional[Tensor] = None
    mat: Optional[Tensor] = None


_NOT_PORTED = ("reparam", "ray_chunk")


@dataclasses.dataclass(frozen=True)
class RenderConfig(_Replace):
    """Static render settings, with the reference's fields and defaults.

    Fields whose features are not ported raise NotImplementedError when set:
    reparam (and its reparam_* tuning fields, inert without it) and
    ray_chunk.  `coherent_bounce` draws one set of bounce uniforms per
    2048-ray tile, shared by the tile's rays; `shared_primary` computes the
    first path vertex (primary hit and its NEE) once for all spp samples
    (see pathtracer._film_render_shared).  env_nee only acts on
    envmap backgrounds, which trace_rays refuses.  `static_geometry` must be
    True: only the kernel-attribute route of the path tracer is ported.
    `backend` must be "auto" (else ValueError): the device of the tensors
    picks the intersection route.  `tile_cull=False` is the port's
    counterpart of the reference's FF_NO_TILE_CULL=1: every ray cast takes
    the kernels without per-tile cluster lists (B6, B3, B7; see
    render/intersect.py); the default keeps the reference's default.
    """

    width: int = 256
    height: int = 256
    spp: int = 4
    max_bounces: int = 2
    ray_chunk: int = 0
    tri_chunk: int = 512
    backend: str = "auto"
    reparam: bool = False
    reparam_k_aux: int = 8
    reparam_chunk: int = 0
    reparam_radius: float = 0.05
    reparam_indirect: bool = False
    reparam_ind_radius: float = 0.05
    reparam_ind_bounces: int = 1
    env_nee: bool = True
    coherent_bounce: bool = False
    shared_primary: bool = False
    static_geometry: bool = False
    tile_cull: bool = True

    def __post_init__(self):
        for name in _NOT_PORTED:
            if getattr(self, name):
                raise NotImplementedError(
                    f"RenderConfig.{name} is not ported to fireflies_tpu_torch yet")
        if self.backend != "auto":
            raise ValueError(f"RenderConfig.backend={self.backend!r}: only 'auto' is supported")
