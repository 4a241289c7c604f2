"""Scene -> renderer bridge (port of fireflies_tpu/render/bridge.py).

`SceneBridge` precomputes the static topology once — faces of every mesh,
Morton-ordered per mesh so that consecutive-face clusters are spatially
tight for the intersection kernels, per-face material and mesh ids, and
the scene-static BSDF lobe flags.  `assemble(params)` turns randomized
param dicts, one per variant, into a batched `RenderScene`.

The projector takes the analytic beam entries ("tex.beams", ...) or a
texture: "tex.data" or "<projector>.irradiance.data" of each variant, else
the constructor's `projector_texture`, else ones((8, 8, 3)); (3, H, W)
textures are moved to (H, W, 3).  A texture that every variant passes as
the same tensor stays one (H, W, 3) texture for the batch.
`projector_aperture` gives it a soft-shadow aperture, a light's "radius"
(a default or a randomized key) the lights'.

Materials take a base-colour texture from "<mat>.base_color.data" or the
Mitsuba-nested "<mat>.brdf_0.base_color.data" of each variant (for a
material with `set_texture` or a sampler on such a key), and roughness and
normal maps from the Material (`set_roughness_texture`,
`set_normal_texture`), which "<mat>.roughness.data" / "<mat>.normalmap.data"
override per variant; each becomes an (M, H, W, C) stack when every
variant passes each material's map as the same tensor (or none), else a
(B, M, H, W, C) stack, with a (B, M) `has_*` mask.  The bridge moves its
own arrays (topology, static maps, envmap, default projector texture) to a
device once.  Faces of materials with a nonzero default emission are the
area lights' sample set.  `background` is a (3,) constant or an (H, W, 3)
envmap, `background_to_world` its rotation.

Mesh uvs are carried (zeros for a mesh without them) when some mesh has
them.  Meshes flagged smooth get area-weighted vertex normals, computed
from each variant's vertices on every assemble (differentiable with
respect to them); flat meshes' rows are zero.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fireflies_tpu_torch import native
from fireflies_tpu_torch.render.cuda import intersect_kernel
from fireflies_tpu_torch.render.types import (
    LIGHT_POINT,
    LIGHT_SPOT,
    Camera,
    Geometry,
    Lights,
    Materials,
    Projector,
    RenderScene,
    compute_vertex_normals,
)
from fireflies_tpu_torch.scene import Scene, canonical_param

Tensor = torch.Tensor

_KIND_CODES = {"point": LIGHT_POINT, "spot": LIGHT_SPOT, "projector": LIGHT_SPOT}

_MATERIAL_FIELDS = (
    "base_color roughness metallic specular spec_tint clearcoat clearcoat_gloss "
    "sheen sheen_tint anisotropic spec_trans flatness ior thin emission"
).split()

_LOBE_FIELDS = {
    "trans": "spec_trans",
    "clearcoat": "clearcoat",
    "sheen": "sheen",
    "aniso": "anisotropic",
    "flatness": "flatness",
}


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _chw_to_hwc(tex: Tensor) -> Tensor:
    """Accept (3, H, W) (the noise-texture sampler's layout) or (H, W, 3)."""
    if tex.dim() == 3 and tex.shape[0] == 3 and tex.shape[-1] != 3:
        return tex.permute(1, 2, 0)
    return tex


class SceneBridge:
    def __init__(
        self,
        scene: Scene,
        camera_fov: float = 45.0,
        camera_near: float = 0.01,
        camera_far: float = 1000.0,
        projector_fov: float = 30.0,
        projector_scale: float = 1.0,
        projector_texture=None,
        projector_aperture=None,
        background=None,
        background_to_world=None,
    ):
        self._scene = scene
        self._on_device: dict = {}  # (name, device) -> the bridge's arrays there
        self._camera_fov = float(camera_fov)
        self._camera_near = float(camera_near)
        self._camera_far = float(camera_far)
        self._projector_fov = float(projector_fov)
        self._projector_scale = float(projector_scale)
        self._projector_texture = (
            np.asarray(projector_texture, np.float32) if projector_texture is not None else None
        )
        self._projector_aperture = (
            float(projector_aperture) if projector_aperture is not None else None
        )
        self._background = (
            np.asarray(background, np.float32) if background is not None else None
        )
        self._background_to_world = (
            np.asarray(background_to_world, np.float32).reshape(4, 4)
            if background_to_world is not None else None
        )

        # ---- static topology ------------------------------------------------
        self._mesh_names = [m.name() for m in scene.meshes()]
        mat_index = {m.name(): i for i, m in enumerate(scene.materials())}
        binding = scene.mesh_material_binding()
        faces_list, face_mesh, face_mat, uvs_list = [], [], [], []
        offset = 0
        any_uv = any(m.uvs() is not None for m in scene.meshes())
        for mi, mesh in enumerate(scene.meshes()):
            f = mesh.faces()
            if f is None:
                raise ValueError(f"mesh {mesh.name()} has no faces")
            faces_list.append(f + offset)
            face_mesh.append(np.full(len(f), mi, np.int32))
            mat_name = binding.get(mesh.name())
            face_mat.append(np.full(len(f), mat_index.get(mat_name, 0) if mat_name else 0,
                                    np.int32))
            if any_uv:
                uv = mesh.uvs()
                if uv is None or uv.shape[0] != mesh.num_vertices():
                    uv = np.zeros((mesh.num_vertices(), 2), np.float32)
                uvs_list.append(uv)
            offset += mesh.num_vertices()
        self._faces = np.concatenate(faces_list).astype(np.int32)
        self._face_mesh = np.concatenate(face_mesh)
        self._face_mat = np.concatenate(face_mat)
        self._uvs = np.concatenate(uvs_list).astype(np.float32) if any_uv else None

        # Smooth-shading vertex mask: 1 on the vertices of smooth meshes, so
        # flat meshes' normal rows are zero (None when no mesh is smooth).
        mask = np.concatenate([np.full(m.num_vertices(), float(m.smooth()), np.float32)
                               for m in scene.meshes()])
        self._smooth_mask = mask if mask.any() else None

        # Morton order by rest-pose centroid, within each mesh (meshes often
        # interleave in space, e.g. a tube around the folds): the native
        # library's, as in the JAX package, or its plain version under
        # FIREFLIES_NO_NATIVE=1.
        rest_verts = np.concatenate(
            [m.get_vertices() + m._centroid[None, :] for m in scene.meshes()])
        centroids = rest_verts[self._faces].mean(axis=1)
        morton_order = native.morton_order if native.enabled() else intersect_kernel.morton_order
        order = np.arange(len(self._faces))
        for mi in range(len(scene.meshes())):
            sel = np.where(self._face_mesh == mi)[0]
            if len(sel) > 1:
                order[sel] = sel[morton_order(centroids[sel])]
        self._faces = self._faces[order]
        self._face_mesh = self._face_mesh[order]
        self._face_mat = self._face_mat[order]

        # Area lights: the faces of materials whose default emission is
        # nonzero (static membership; the values may be randomized).
        emissive = [i for i, m in enumerate(scene.materials())
                    if np.any(np.asarray(m.params().get("emission", 0.0), np.float32) > 0)]
        self._emissive_faces = (np.where(np.isin(self._face_mat, emissive))[0]
                                if emissive else None)
        self._texture_mats = {
            i for i, m in enumerate(scene.materials())
            if m.texture() is not None or any("base_color.data" in k for k in m.vec3_attributes())
        }
        self._static_maps = {
            "roughness.data": {i: np.asarray(m.roughness_texture(), np.float32)
                               for i, m in enumerate(scene.materials())
                               if m.roughness_texture() is not None},
            "normalmap.data": {i: np.asarray(m.normal_texture(), np.float32)
                               for i, m in enumerate(scene.materials())
                               if m.normal_texture() is not None},
        }

        # Scene-static lobe flags: a lobe is on iff some material's base value
        # of its field is nonzero or the field is randomized by a sampler.
        def lobe_active(field: str) -> bool:
            for m in scene.materials():
                if np.any(np.asarray(m.params().get(field, 0.0), np.float32) != 0):
                    return True
                keys = list(m.float_attributes()) + list(m.vec3_attributes())
                if any(k == field or canonical_param(k) == field for k in keys):
                    return True
            return False

        self._lobe_flags = frozenset(
            lobe for lobe, field in _LOBE_FIELDS.items() if lobe_active(field))

    # ------------------------------------------------------------------

    def assemble(self, params: dict | list[dict]) -> RenderScene:
        """One randomized param dict per variant (a single dict = one
        variant) -> RenderScene with a leading variant axis."""
        variants = [params] if isinstance(params, dict) else list(params)
        scene = self._scene
        dev = variants[0][self._mesh_names[0] + ".vertex_positions"].device

        def stack(key, default=None, shape=None):
            vals = []
            for p in variants:
                v = p.get(key, default)
                v = _f32(v, dev)
                vals.append(v.reshape(shape) if shape is not None else v)
            return torch.stack(vals)

        verts = torch.stack([
            torch.cat([p[name + ".vertex_positions"] for name in self._mesh_names])
            for p in variants])
        faces = self._on("faces", self._faces, dev, torch.long)
        normals = None
        if self._smooth_mask is not None:
            normals = (compute_vertex_normals(verts, faces)
                       * self._on("smooth_mask", self._smooth_mask, dev)[:, None])
        geometry = Geometry(
            vertices=verts,
            faces=faces,
            face_mat=self._on("face_mat", self._face_mat, dev, torch.long),
            face_mesh=self._on("face_mesh", self._face_mesh, dev, torch.long),
            uvs=self._on("uvs", self._uvs, dev),
            normals=normals,
            emissive_faces=self._on("emissive_faces", self._emissive_faces, dev, torch.long),
        )

        # ---- materials ------------------------------------------------------
        mats = scene.materials()
        fields = {}
        for field in _MATERIAL_FIELDS:
            width = 3 if field in ("base_color", "emission") else 1
            rows = []
            for m in mats:
                v = stack(m.name() + "." + field).reshape(len(variants), -1)
                rows.append(v[:, :3].expand(-1, 3) if width == 3 else v[:, 0])
            fields[field] = torch.stack(rows, dim=1)
        materials = Materials(**fields, **self._material_maps(variants, dev),
                              flags=self._lobe_flags)

        # ---- lights ---------------------------------------------------------
        light_ents = scene.lights()
        cutoffs, beams, intensities, worlds = [], [], [], []
        for li in light_ents:
            name = li.name()
            worlds.append(stack(name + ".to_world"))
            intensities.append(stack(name + ".intensity",
                                     li.defaults().get("intensity", (1.0, 1.0, 1.0))
                                     ).reshape(len(variants), -1)[:, :3])
            cutoff_deg = stack(name + ".cutoff_angle", li.defaults().get("cutoff_angle", 20.0),
                               shape=())
            beam_default = li.defaults().get("beam_width")
            beam_deg = (torch.full_like(cutoff_deg, float(beam_default)) if beam_default
                        else cutoff_deg * 0.75)
            cutoffs.append(torch.cos(torch.deg2rad(cutoff_deg)))
            beams.append(torch.cos(torch.deg2rad(beam_deg)))
        b = len(variants)
        lights = Lights(
            kinds=tuple(_KIND_CODES.get(li.kind(), LIGHT_POINT) for li in light_ents),
            to_world=(torch.stack(worlds, 1) if worlds else torch.zeros(b, 0, 4, 4, device=dev)),
            intensity=(torch.stack(intensities, 1) if worlds
                       else torch.zeros(b, 0, 3, device=dev)),
            cutoff_cos=(torch.stack(cutoffs, 1) if worlds else torch.zeros(b, 0, device=dev)),
            beam_cos=(torch.stack(beams, 1) if worlds else torch.zeros(b, 0, device=dev)),
            active=torch.ones(b, len(light_ents), dtype=torch.bool, device=dev),
        )
        # Soft-shadow radii, present when some light has one (a default or
        # a randomized key); absent, NEE keeps the shared-origin route.
        if any(li.defaults().get("radius") is not None
               or any(li.name() + ".radius" in p for p in variants) for li in light_ents):
            lights = lights.replace(radius=torch.stack(
                [stack(li.name() + ".radius", li.defaults().get("radius", 0.0), shape=())
                 for li in light_ents], 1))

        # ---- camera ---------------------------------------------------------
        cam_ent = scene.camera()
        if cam_ent is None:
            raise ValueError("scene has no camera")
        cname = cam_ent.name()
        camera = Camera(
            to_world=stack(cname + ".to_world"),
            fov=stack(cname + ".fov", self._camera_fov).reshape(b, -1)[:, 0],
            near=torch.full((b,), self._camera_near, device=dev),
            far=torch.full((b,), self._camera_far, device=dev),
        )

        # ---- projector --------------------------------------------------------
        projector: Optional[Projector] = None
        proj_ent = scene.projector()
        if proj_ent is not None:
            pname = proj_ent.name()
            pose = dict(
                to_world=stack(pname + ".to_world"),
                fov=stack(pname + ".fov", self._projector_fov).reshape(b, -1)[:, 0],
                near=torch.full((b,), self._camera_near, device=dev),
                far=torch.full((b,), self._camera_far, device=dev),
                scale=torch.full((b,), self._projector_scale, device=dev),
                aperture=(torch.full((b,), self._projector_aperture, device=dev)
                          if self._projector_aperture is not None else None),
            )
            analytic = ["tex.beams" in p for p in variants]
            if any(analytic) and not all(analytic):
                raise ValueError("every variant or none must pass the analytic 'tex.beams'")
            if all(analytic):
                hw = variants[0].get("tex.beam_hw", (256, 256))
                projector = Projector(
                    **pose,
                    texture=None,
                    beams_ndc=torch.stack([p["tex.beams"] for p in variants]),
                    beam_sigma=stack("tex.beam_sigma", 10.0, shape=()),
                    beam_color=stack("tex.beam_color", (0.0, 1.0, 0.0), shape=(3,)),
                    beam_hw=(int(hw[0]), int(hw[1])),
                )
            else:
                projector = Projector(**pose, texture=self._projector_textures(variants, pname,
                                                                               dev))

        return RenderScene(
            geometry=geometry, materials=materials, lights=lights, camera=camera,
            projector=projector,
            background=self._on("background", self._background, dev),
            background_to_world=self._on("background_to_world", self._background_to_world, dev))

    def _on(self, key, array, dev, dtype=torch.float32) -> Tensor | None:
        """The bridge's own `array` (None stays None) on `dev`, moved there
        once and kept under `key`."""
        if array is None:
            return None
        if (key, dev) not in self._on_device:
            self._on_device[key, dev] = torch.as_tensor(array, dtype=dtype, device=dev)
        return self._on_device[key, dev]

    def _material_maps(self, variants: list[dict], dev) -> dict:
        """The Materials fields of the maps: `textures` (M, H, W, 3) or
        (B, M, H, W, 3) from each variant's base-colour key, `roughness_tex`
        (..., M, H, W, 1) and `normal_tex` (..., M, H, W, 3) from its
        ".roughness.data" / ".normalmap.data" key or the Material's static
        map, each with its (B, M) `has_*` mask; zeros where a material has
        none.  A stack drops the variant axis when every variant passes
        each material's map as the same tensor (or none)."""
        mats = self._scene.materials()
        out = {}

        def table(lookup, chans):
            # cols[i][b]: material i's map in variant b, or None.
            cols = [[lookup(p, i, m) for p in variants] for i, m in enumerate(mats)]
            maps = {id(t): t for col in cols for t in col if t is not None}
            if not maps:
                return None
            for key, t in maps.items():
                t = _f32(t, dev)
                maps[key] = t[..., None] if chans == 1 and t.dim() == 2 else _chw_to_hwc(t)
            zeros = torch.zeros(next(iter(maps.values())).shape, device=dev)
            has = torch.tensor([[col[b] is not None for col in cols] for b in range(len(variants))],
                               device=dev)

            def row(b):
                return torch.stack([zeros if col[b] is None else maps[id(col[b])] for col in cols])

            if all(t is col[0] for col in cols for t in col):
                return row(0), has
            return torch.stack([row(b) for b in range(len(variants))]), has

        def base_color(p, i, m):
            if i not in self._texture_mats:
                return None
            prefix = m.name() + "."
            key = next((k for k in p if k.startswith(prefix) and k.endswith("base_color.data")),
                       None)
            return p[key] if key is not None else None

        got = table(base_color, 3)
        if got is not None:
            out["textures"], out["has_texture"] = got
        for attr, field, flag, chans in (("roughness.data", "roughness_tex", "has_roughness_tex", 1),
                                         ("normalmap.data", "normal_tex", "has_normal_tex", 3)):
            static = {i: self._on((attr, i), t, dev) for i, t in self._static_maps[attr].items()}
            got = table(lambda p, i, m, attr=attr, static=static:
                        p.get(m.name() + "." + attr, static.get(i)), chans)
            if got is not None:
                out[field], out[flag] = got
        return out

    def _projector_textures(self, variants: list[dict], pname: str, dev) -> Tensor:
        """The projector texture of each variant: (H, W, 3) when every variant
        has the same one (the same tensor, or the default), else the
        (B, H, W, 3) stack."""
        default = (self._projector_texture if self._projector_texture is not None
                   else np.ones((8, 8, 3), np.float32))
        raw = [p.get("tex.data", p.get(pname + ".irradiance.data")) for p in variants]
        raw = [self._on("projector_texture", default, dev) if t is None else t for t in raw]
        if all(t is raw[0] for t in raw):
            return _chw_to_hwc(_f32(raw[0], dev))
        return torch.stack([_chw_to_hwc(_f32(t, dev)) for t in raw])
