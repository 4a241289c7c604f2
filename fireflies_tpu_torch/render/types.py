"""Renderer data model (port of fireflies_tpu/render/types.py).

Dataclasses of tensors with a leading variant axis B: every per-variant
field carries it (vertices (B, V, 3), camera to_world (B, 4, 4), material
rows (B, M), ...), while static topology and tables shared by every variant
(faces, face_mat, light kinds) do not.  `SceneBridge.assemble` builds these
from one randomized param dict per variant.  Scene-static tables carry no
variant axis: the envmap background and its orientation, the emissive-face
set, the lobe flags.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fireflies_tpu_torch.render.vec3 import rsqrt

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
    aperture: Optional[Tensor] = None  # (B,) soft-shadow aperture radius
    beams_ndc: Optional[Tensor] = None
    beam_sigma: Optional[Tensor] = None
    beam_color: Optional[Tensor] = None
    beam_hw: Optional[tuple] = None


@dataclasses.dataclass
class Lights(_Replace):
    """Fixed-slot delta-light table (point / spot).  Spot falloff: full
    intensity inside `beam_cos`, linear in cosine to `cutoff_cos`.  With
    `radius`, NEE visibility is averaged over a disk of that radius in each
    light's local XY plane (one jittered origin a shadow ray) while the
    radiance keeps the delta model; radius 0 is hard but takes the
    per-ray-origin occlusion route."""

    kinds: tuple  # (L,) python ints, static
    to_world: Tensor  # (B, L, 4, 4)
    intensity: Tensor  # (B, L, 3)
    cutoff_cos: Tensor  # (B, L)
    beam_cos: Tensor  # (B, L)
    active: Tensor  # (B, L) bool
    radius: Optional[Tensor] = None  # (B, L) soft-shadow aperture radii

    @property
    def count(self) -> int:
        return len(self.kinds)


@dataclasses.dataclass
class Materials(_Replace):
    """Principled-BSDF parameter table, one row per material: (B, M) scalars,
    (B, M, 3) colours.  `flags` is the scene-static set of optional lobes any
    material can activate (None = all).  Optional maps, looked up at the
    hit's uv where the material's `has_*` flag (B, M) is set: `textures`
    (B, M, Ht, Wt, 3) base colour, `roughness_tex` (B, M, Hr, Wr, 1) in
    [0, 1] in place of the scalar roughness, `normal_tex` (B, M, Hn, Wn, 3)
    tangent-space normals as RGB in [0, 1] (n = 2 rgb - 1).  A stack the
    variants share drops its leading axis: (M, H, W, C)."""

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
    textures: Optional[Tensor] = None
    has_texture: Optional[Tensor] = None
    roughness_tex: Optional[Tensor] = None
    has_roughness_tex: Optional[Tensor] = None
    normal_tex: Optional[Tensor] = None
    has_normal_tex: Optional[Tensor] = None
    flags: Optional[frozenset] = None


@dataclasses.dataclass
class Geometry(_Replace):
    """Triangle soup: world-space vertices per variant over a static
    topology with per-face material / mesh ids.  `uvs` are shared by every
    variant (zeros for meshes without them).  `normals` are smooth-shading
    vertex normals per variant (`compute_vertex_normals`); all-zero rows
    mark flat-shaded vertices, where the hit attributes fall back to the
    geometric normal.  `emissive_faces` (E,) are the faces of materials
    whose default emission is nonzero: the area lights' sample set (static
    membership; the emission values may be randomized)."""

    vertices: Tensor  # (B, V, 3)
    faces: Tensor  # (F, 3) int64
    face_mat: Tensor  # (F,) int64
    face_mesh: Tensor  # (F,) int64
    uvs: Optional[Tensor] = None  # (V, 2)
    emissive_faces: Optional[Tensor] = None  # (E,) int64
    normals: Optional[Tensor] = None  # (B, V, 3)

    def triangle_corners(self):
        """(v0, e1, e2), each (B, F, 3), for Möller-Trumbore."""
        v0 = self.vertices[:, self.faces[:, 0]]
        v1 = self.vertices[:, self.faces[:, 1]]
        v2 = self.vertices[:, self.faces[:, 2]]
        return v0, v1 - v0, v2 - v0


def compute_vertex_normals(vertices: Tensor, faces: Tensor) -> Tensor:
    """Area-weighted unit vertex normals (B, V, 3) of vertices (B, V, 3),
    differentiable with respect to the vertices: each face's unnormalized
    (hence area-weighted) normal is added onto its three corners.  The
    radicand of the rsqrt is max-guarded, so exactly-zero rows
    (unreferenced vertices) stay zero with a finite cotangent."""
    v0, v1, v2 = (vertices[:, faces[:, k]] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)  # |fn| = 2 * area
    vn = torch.zeros_like(vertices)
    for k in range(3):
        vn = vn.index_add(1, faces[:, k], fn)
    n2 = (vn * vn).sum(dim=-1, keepdim=True)
    return vn * rsqrt(torch.clamp(n2, min=1e-24)) * (n2 > 1e-24)


@dataclasses.dataclass
class RenderScene(_Replace):
    geometry: Geometry
    materials: Materials
    lights: Lights
    camera: Camera
    projector: Optional[Projector] = None
    # Escape radiance: a (3,) constant or an (H, W, 3) equirectangular
    # envmap (texture.sample_envmap), shared by every variant; its rotation
    # `background_to_world` (4, 4) pulls directions into the map's frame.
    background: Optional[Tensor] = None
    background_to_world: Optional[Tensor] = None

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


@dataclasses.dataclass(frozen=True)
class RenderConfig(_Replace):
    """Static render settings, with the reference's fields and defaults.

    `reparam` renders with warped-area boundary gradients (render/reparam.py):
    the value from an ordinary pass, the gradient from a second pass whose
    primary samples are warped (`reparam_k_aux` aux rays in an NDC disk of
    `reparam_radius`, recomputed `reparam_chunk` rays at a time in the
    backward; 0 = the whole film), with shadow-boundary terms for every
    delta emitter; `reparam_indirect` also warps the BSDF-sampled
    directions of the first `reparam_ind_bounces` bounces (radius
    `reparam_ind_radius`).  The film must divide into 128x16 tiles.
    `ray_chunk` traces the film in chunks of that many rays, one after the
    other (not under `reparam`).
    `coherent_bounce` draws one set of bounce uniforms per 2048-ray tile,
    shared by the tile's rays; `shared_primary` computes the first path
    vertex (primary hit and its NEE) once for all spp samples (see
    pathtracer._film_render_shared; off under `ray_chunk`).  `env_nee`
    importance-samples an (H, W, 3) envmap background as an emitter, with
    power-heuristic MIS against BSDF-sampled escapes.
    `static_geometry=True` takes positions, normals and material ids from
    the intersection kernels (the vertices get no gradient); the default
    re-derives them differentiably from the face table
    (intersect.hit_attributes_table), as does any scene with smooth
    normals, material maps or (on a mesh with uvs) the anisotropic lobe.
    `backend` must be "auto" (else ValueError): the device of the
    tensors picks the intersection route.  `tile_cull=False` is the port's
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
        if self.backend != "auto":
            raise ValueError(f"RenderConfig.backend={self.backend!r}: only 'auto' is supported")
