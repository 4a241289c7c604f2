"""Scene -> renderer bridge (port of fireflies_tpu/render/bridge.py).

`SceneBridge` precomputes the static topology once — faces of every mesh,
Morton-ordered per mesh so that consecutive-face clusters are spatially
tight for the intersection kernels, per-face material and mesh ids, and
the scene-static BSDF lobe flags.  `assemble(params)` turns randomized
param dicts, one per variant, into a batched `RenderScene`.

Not ported yet: textures, smooth vertex normals and area lights; a scene
that needs them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fireflies_tpu_torch.render.cuda.intersect_kernel import morton_order
from fireflies_tpu_torch.render.types import (
    LIGHT_POINT,
    LIGHT_SPOT,
    Camera,
    Geometry,
    Lights,
    Materials,
    Projector,
    RenderScene,
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


class SceneBridge:
    def __init__(
        self,
        scene: Scene,
        camera_fov: float = 45.0,
        camera_near: float = 0.01,
        camera_far: float = 1000.0,
        projector_fov: float = 30.0,
        projector_scale: float = 1.0,
        background=None,
    ):
        self._scene = scene
        self._camera_fov = float(camera_fov)
        self._camera_near = float(camera_near)
        self._camera_far = float(camera_far)
        self._projector_fov = float(projector_fov)
        self._projector_scale = float(projector_scale)
        self._background = (
            np.asarray(background, np.float32) if background is not None else None
        )
        if self._background is not None and self._background.ndim != 1:
            raise NotImplementedError("envmap backgrounds are not ported")

        # ---- static topology ------------------------------------------------
        self._mesh_names = [m.name() for m in scene.meshes()]
        mat_index = {m.name(): i for i, m in enumerate(scene.materials())}
        binding = scene.mesh_material_binding()
        faces_list, face_mesh, face_mat = [], [], []
        offset = 0
        for mi, mesh in enumerate(scene.meshes()):
            if mesh.smooth():
                raise NotImplementedError("smooth vertex normals are not ported")
            f = mesh.faces()
            if f is None:
                raise ValueError(f"mesh {mesh.name()} has no faces")
            faces_list.append(f + offset)
            face_mesh.append(np.full(len(f), mi, np.int32))
            mat_name = binding.get(mesh.name())
            face_mat.append(np.full(len(f), mat_index.get(mat_name, 0) if mat_name else 0,
                                    np.int32))
            offset += mesh.num_vertices()
        self._faces = np.concatenate(faces_list).astype(np.int32)
        self._face_mesh = np.concatenate(face_mesh)
        self._face_mat = np.concatenate(face_mat)

        # Morton order by rest-pose centroid, within each mesh (meshes often
        # interleave in space, e.g. a tube around the folds).
        rest_verts = np.concatenate(
            [m.get_vertices() + m._centroid[None, :] for m in scene.meshes()])
        centroids = rest_verts[self._faces].mean(axis=1)
        order = np.arange(len(self._faces))
        for mi in range(len(scene.meshes())):
            sel = np.where(self._face_mesh == mi)[0]
            if len(sel) > 1:
                order[sel] = sel[morton_order(centroids[sel])]
        self._faces = self._faces[order]
        self._face_mesh = self._face_mesh[order]
        self._face_mat = self._face_mat[order]

        for m in scene.materials():
            if np.any(np.asarray(m.params().get("emission", 0.0), np.float32) > 0):
                raise NotImplementedError("area lights (emissive materials) are not ported")
            if any(k.endswith(".data") for k in m.vec3_attributes()):
                raise NotImplementedError("material textures are not ported")

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
        geometry = Geometry(
            vertices=verts,
            faces=torch.as_tensor(self._faces, dtype=torch.long, device=dev),
            face_mat=torch.as_tensor(self._face_mat, dtype=torch.long, device=dev),
            face_mesh=torch.as_tensor(self._face_mesh, dtype=torch.long, device=dev),
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
        materials = Materials(**fields, flags=self._lobe_flags)

        # ---- lights ---------------------------------------------------------
        light_ents = scene.lights()
        for li in light_ents:
            if li.defaults().get("radius") is not None or any(
                    li.name() + ".radius" in p for p in variants):
                raise NotImplementedError("soft-shadow light apertures are not ported")
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

        # ---- projector (analytic beam mode) ---------------------------------
        projector: Optional[Projector] = None
        proj_ent = scene.projector()
        if proj_ent is not None:
            if any("tex.beams" not in p for p in variants):
                raise NotImplementedError(
                    "only the analytic beam-splat projector is ported: pass 'tex.beams'")
            pname = proj_ent.name()
            hw = variants[0].get("tex.beam_hw", (256, 256))
            projector = Projector(
                to_world=stack(pname + ".to_world"),
                fov=stack(pname + ".fov", self._projector_fov).reshape(b, -1)[:, 0],
                near=torch.full((b,), self._camera_near, device=dev),
                far=torch.full((b,), self._camera_far, device=dev),
                texture=None,
                scale=torch.full((b,), self._projector_scale, device=dev),
                beams_ndc=torch.stack([p["tex.beams"] for p in variants]),
                beam_sigma=stack("tex.beam_sigma", 10.0, shape=()),
                beam_color=stack("tex.beam_color", (0.0, 1.0, 0.0), shape=(3,)),
                beam_hw=(int(hw[0]), int(hw[1])),
            )

        background = (_f32(self._background, dev) if self._background is not None else None)
        return RenderScene(geometry=geometry, materials=materials, lights=lights,
                           camera=camera, projector=projector, background=background)
