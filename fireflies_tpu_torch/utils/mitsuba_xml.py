"""Minimal Mitsuba-XML scene ingestion (port of
fireflies_tpu/utils/mitsuba_xml.py).

Users of the reference build scenes from Mitsuba XML.  This loader parses
the subset of Mitsuba 3 XML those workloads use — perspective sensors, OBJ/serialized shape refs
(OBJ supported), rectangle/cube primitives, principled BSDFs, point/spot
emitters, projector emitters with irradiance textures — into the same flat
param-dict convention `Scene.from_params` ingests, preserving the key-prefix
naming (`mesh-*`, `mat-*`, `emit-*`, `PerspectiveCamera`, `Projector`;
README of the reference: "export ids so names carry mesh/brdf/... prefixes").

Returns (params, meta): `params` feeds Scene.from_params; `meta` carries
non-param data (film size, fov, obj paths) for SceneBridge configuration.

It reads what the JAX package's loader reads and fails where it fails:
a `<ref id=.../>` inside a `<shape>` is not followed (only an inline
`<bsdf>` binds a material, so such shapes take material 0), and a
`<point>` given as x=/y=/z= attributes raises (only `value=` is read).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from fireflies_tpu_torch.assets import procedural
from fireflies_tpu_torch.utils import io as ffio


def _parse_transform(node) -> np.ndarray:
    """Compose a Mitsuba <transform> block into a 4x4 matrix."""
    m = np.eye(4, dtype=np.float32)
    if node is None:
        return m
    for child in node:
        tag = child.tag
        if tag == "matrix":
            vals = [float(v) for v in child.get("value").split()]
            t = np.asarray(vals, np.float32).reshape(4, 4)
        elif tag == "translate":
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = [_f(child, "x"), _f(child, "y"), _f(child, "z")]
        elif tag == "scale":
            t = np.eye(4, dtype=np.float32)
            if child.get("value") is not None:
                s = float(child.get("value"))
                t[0, 0] = t[1, 1] = t[2, 2] = s
            else:
                t[0, 0] = _f(child, "x", 1.0)
                t[1, 1] = _f(child, "y", 1.0)
                t[2, 2] = _f(child, "z", 1.0)
        elif tag == "rotate":
            angle = np.deg2rad(float(child.get("angle", 0)))
            axis = np.asarray(
                [_f(child, "x"), _f(child, "y"), _f(child, "z")], np.float64
            )
            axis = axis / (np.linalg.norm(axis) + 1e-12)
            c, s = np.cos(angle), np.sin(angle)
            x, y, z = axis
            r = np.asarray(
                [
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
                ],
                np.float32,
            )
            t = np.eye(4, dtype=np.float32)
            t[:3, :3] = r
        elif tag == "lookat":
            origin = _vec(child.get("origin"))
            target = _vec(child.get("target"))
            up = _vec(child.get("up", "0, 1, 0"))
            fwd = target - origin
            fwd /= np.linalg.norm(fwd) + 1e-12
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right) + 1e-12
            true_up = np.cross(right, fwd)
            t = np.eye(4, dtype=np.float32)
            t[:3, 0] = right
            t[:3, 1] = true_up
            t[:3, 2] = -fwd  # our cameras look down -Z
            t[:3, 3] = origin
        else:
            continue
        m = t @ m
    return m


def _f(node, attr, default=0.0) -> float:
    v = node.get(attr)
    return float(v) if v is not None else default


def _vec(text) -> np.ndarray:
    parts = text.replace(",", " ").split()
    return np.asarray([float(p) for p in parts], np.float32)


def _named_children(node) -> dict:
    out = {}
    for child in node:
        name = child.get("name")
        if name is None:
            continue
        if child.tag in ("float", "integer"):
            out[name] = float(child.get("value"))
        elif child.tag in ("rgb", "spectrum", "vector", "point"):
            out[name] = _vec(child.get("value"))
        elif child.tag == "string":
            out[name] = child.get("value")
        elif child.tag == "boolean":
            out[name] = child.get("value") == "true"
        elif child.tag == "transform":
            out[name] = _parse_transform(child)
    return out


_PRIMITIVE_SHAPES = {
    "rectangle": lambda: procedural.make_plane(1.0, 1)[:2],
    "cube": lambda: procedural.make_box(1.0),
    "sphere": lambda: procedural.make_sphere(1.0)[:2],
}


def load_mitsuba_xml(path: str | Path) -> tuple[dict, dict]:
    """Parse a Mitsuba XML scene into (flat params dict, meta)."""
    path = Path(path)
    root = ET.parse(path).getroot()
    base = path.parent

    params: dict = {}
    meta: dict = {"film": (256, 256), "camera_fov": 45.0, "projector_fov": 30.0}
    mesh_i = 0
    mat_i = 0
    emit_i = 0
    cam_i = 0

    def shape_name(node, default):
        sid = node.get("id") or default
        return sid if any(sid.lower().startswith(p) for p in ("mesh", "ply")) else f"mesh-{sid}"

    for node in root:
        if node.tag == "sensor":
            props = _named_children(node)
            name = "PerspectiveCamera" if cam_i == 0 else f"PerspectiveCamera_{cam_i}"
            cam_i += 1
            params[name + ".to_world"] = props.get("to_world", np.eye(4, dtype=np.float32))
            if "fov" in props:
                params[name + ".x_fov"] = float(props["fov"])
                meta["camera_fov"] = float(props["fov"])
            meta["camera_near"] = float(props.get("near_clip", 0.01))
            meta["camera_far"] = float(props.get("far_clip", 1000.0))
            film = node.find("film")
            if film is not None:
                fp = _named_children(film)
                meta["film"] = (int(fp.get("width", 256)), int(fp.get("height", 256)))

        elif node.tag == "shape":
            props = _named_children(node)
            stype = node.get("type")
            name = shape_name(node, f"mesh_{mesh_i}")
            mesh_i += 1
            if stype in ("obj", "ply", "serialized"):
                data = ffio.load_mesh(
                    base / props["filename"],
                    shape_index=int(props.get("shape_index", 0)),
                )
                verts, faces = data["vertices"], data["faces"]
            elif stype in _PRIMITIVE_SHAPES:
                verts, faces = _PRIMITIVE_SHAPES[stype]()
            else:
                raise NotImplementedError(f"shape type {stype}")
            to_world = props.get("to_world")
            if to_world is not None:
                homo = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], -1)
                verts = (homo @ to_world.T)[:, :3]
            params[name + ".vertex_positions"] = verts.astype(np.float32)
            params[name + ".faces"] = faces.astype(np.int32)

            bsdf = node.find("bsdf")
            if bsdf is not None:
                inner = bsdf.find("bsdf")  # twosided wrapper
                if inner is None:
                    inner = bsdf
                bid = bsdf.get("id") or f"bsdf_{mat_i}"
                mat_name = bid if bid.lower().startswith(("mat", "bsdf", "brdf")) else f"mat-{bid}"
                mat_i += 1
                for k, v in _named_children(inner).items():
                    params[f"{mat_name}.brdf_0.{k}.value"] = v
                meta.setdefault("bindings", {})[name] = mat_name

            emitter = node.find("emitter")
            if emitter is not None:  # area emitter attached to shape
                for k, v in _named_children(emitter).items():
                    params[f"{name}.emitter.{k}"] = v

        elif node.tag == "emitter":
            etype = node.get("type")
            props = _named_children(node)
            eid = node.get("id") or f"emit_{emit_i}"
            emit_i += 1
            if etype == "projector":
                name = "Projector"
                params[name + ".to_world"] = props.get("to_world", np.eye(4, dtype=np.float32))
                if "fov" in props:
                    meta["projector_fov"] = float(props["fov"])
                tex = node.find("texture")
                if tex is not None:
                    tp = _named_children(tex)
                    if "filename" in tp:
                        meta["projector_texture_path"] = str(base / tp["filename"])
                if "scale" in props:
                    meta["projector_scale"] = float(props["scale"])
            elif etype == "constant":
                # Uniform sky: RenderScene.background radiance on escape.
                rad = np.asarray(props.get("radiance", 1.0), np.float32)
                meta["background"] = np.broadcast_to(rad.reshape(-1), (3,)).copy()
            elif etype == "envmap":
                # Equirectangular environment emitter: a (H, W, 3) background
                # sampled by escaped-ray direction (render/texture.py
                # sample_envmap).  LDR textures only (utils/png.py).
                meta["envmap_path"] = str(base / props["filename"])
                meta["envmap_scale"] = float(props.get("scale", 1.0))
                if "to_world" in props:
                    meta["envmap_to_world"] = props["to_world"]
            else:
                name = eid if eid.lower().startswith(("emit", "light", "spot")) else f"emit-{eid}"
                params[name + ".to_world"] = props.get("to_world", np.eye(4, dtype=np.float32))
                if "position" in props:
                    t = np.eye(4, dtype=np.float32)
                    t[:3, 3] = props["position"]
                    params[name + ".to_world"] = t
                if "intensity" in props:
                    params[name + ".intensity.value"] = np.asarray(props["intensity"], np.float32)
                if "cutoff_angle" in props:
                    params[name + ".cutoff_angle"] = float(props["cutoff_angle"])
                meta.setdefault("light_kinds", {})[name] = (
                    "spot" if etype in ("spot", "projector") else "point"
                )

        elif node.tag == "bsdf":  # top-level (referenced) bsdf
            inner = node.find("bsdf")
            if inner is None:
                inner = node
            bid = node.get("id") or f"bsdf_{mat_i}"
            mat_name = bid if bid.lower().startswith(("mat", "bsdf", "brdf")) else f"mat-{bid}"
            mat_i += 1
            for k, v in _named_children(inner).items():
                params[f"{mat_name}.brdf_0.{k}.value"] = v

    return params, meta


def scene_from_mitsuba_xml(path: str | Path):
    """XML -> (Scene, bridge_kwargs, meta)."""
    from fireflies_tpu_torch.scene import Scene  # noqa: PLC0415

    params, meta = load_mitsuba_xml(path)
    scene = Scene.from_params(params)
    for mesh_name, mat_name in meta.get("bindings", {}).items():
        scene.bind_material(mesh_name, mat_name)
    for light_name, kind in meta.get("light_kinds", {}).items():
        light = scene.light(light_name)
        if light is not None:
            light._kind = kind
    bridge_kwargs = {
        "camera_fov": meta.get("camera_fov", 45.0),
        "camera_near": meta.get("camera_near", 0.01),
        "camera_far": meta.get("camera_far", 1000.0),
        "projector_fov": meta.get("projector_fov", 30.0),
    }
    if "projector_scale" in meta:
        bridge_kwargs["projector_scale"] = meta["projector_scale"]
    if "envmap_path" in meta:
        from fireflies_tpu_torch.utils.png import read_png  # noqa: PLC0415

        env = read_png(meta["envmap_path"]).astype(np.float32) / 255.0
        if env.ndim == 2:
            env = np.repeat(env[..., None], 3, axis=-1)
        bridge_kwargs["background"] = env[..., :3] * meta.get("envmap_scale", 1.0)
        if "envmap_to_world" in meta:
            bridge_kwargs["background_to_world"] = meta["envmap_to_world"]
    elif "background" in meta:
        bridge_kwargs["background"] = meta["background"]
    return scene, bridge_kwargs, meta
