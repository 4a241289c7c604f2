"""Export one variant of an assembled RenderScene to a Mitsuba 3 scene
bundle (XML + OBJ) (port of fireflies_tpu/utils/mitsuba_export.py).

The inverse of utils/mitsuba_xml.py's loader: render the same assembled
scene in Mitsuba and in this package to compare the images.

Conventions mapped:
  * Camera: ours looks down -Z with NDC x right / y up; exported via a
    Mitsuba `to_world` built from the same eye/target/up (Mitsuba's
    perspective sensor looks down +Z with x LEFT, handled with a 180-degree
    y-rotation, i.e. target mirroring).
  * Materials: principled BSDF with the same parameter names; emissive
    materials become `area` emitters on their shapes.
  * Lights: point / spot with intensity in W/sr (ours matches).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["export_render_scene"]


def _obj_write(path: Path, verts: np.ndarray, faces: np.ndarray, uvs=None) -> None:
    lines = []
    for v in verts:
        lines.append(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}")
    if uvs is not None:
        for t in uvs:
            lines.append(f"vt {t[0]:.8f} {t[1]:.8f}")
        for f in faces + 1:
            lines.append(f"f {f[0]}/{f[0]} {f[1]}/{f[1]} {f[2]}/{f[2]}")
    else:
        for f in faces + 1:
            lines.append(f"f {f[0]} {f[1]} {f[2]}")
    path.write_text("\n".join(lines) + "\n")


def _mat_xml(mat_id: int, m: dict) -> str:
    rgb = m["base_color"]
    parts = [
        f'  <bsdf type="principled" id="mat{mat_id}">',
        f'    <rgb name="base_color" value="{rgb[0]:.6f} {rgb[1]:.6f} {rgb[2]:.6f}"/>',
    ]
    for ours, mits in (
        ("roughness", "roughness"), ("metallic", "metallic"),
        ("specular", "specular"), ("spec_tint", "spec_tint"),
        ("clearcoat", "clearcoat"), ("clearcoat_gloss", "clearcoat_gloss"),
        ("sheen", "sheen"), ("sheen_tint", "sheen_tint"),
        ("anisotropic", "anisotropic"), ("spec_trans", "spec_trans"),
        ("flatness", "flatness"),
    ):
        parts.append(f'    <float name="{mits}" value="{float(m[ours]):.6f}"/>')
    parts.append(f'    <float name="eta" value="{float(m["ior"]):.6f}"/>')
    parts.append("  </bsdf>")
    return "\n".join(parts)


def _np(x, dtype=np.float32) -> np.ndarray:
    return x.detach().cpu().numpy().astype(dtype)


def export_render_scene(rs, out_dir: str | Path, name: str = "scene", spp: int = 64,
                        width: int = 512, height: int = 512, variant: int = 0) -> Path:
    """Write `<out_dir>/<name>.xml` + per-mesh OBJs of variant `variant` of
    the batched RenderScene `rs` (world-space vertices); returns the XML
    path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    b = variant

    verts = _np(rs.geometry.vertices[b])
    faces = _np(rs.geometry.faces, np.int64)
    face_mat = _np(rs.geometry.face_mat, np.int64)
    face_mesh = _np(rs.geometry.face_mesh, np.int64)
    uvs = None if rs.geometry.uvs is None else _np(rs.geometry.uvs)

    mats = rs.materials
    m_np = {
        f: _np(getattr(mats, f)[b])
        for f in (
            "base_color roughness metallic specular spec_tint clearcoat "
            "clearcoat_gloss sheen sheen_tint anisotropic spec_trans flatness "
            "ior emission"
        ).split()
    }

    shapes = []
    for mesh_id in np.unique(face_mesh):
        fsel = faces[face_mesh == mesh_id]
        mat_id = int(face_mat[face_mesh == mesh_id][0])
        used = np.unique(fsel)
        remap = -np.ones(verts.shape[0], np.int64)
        remap[used] = np.arange(used.size)
        obj = out / f"{name}_mesh{int(mesh_id)}.obj"
        _obj_write(obj, verts[used], remap[fsel],
                   None if uvs is None else uvs[used])
        emission = m_np["emission"][mat_id]
        emitter = ""
        if float(np.max(emission)) > 0:
            emitter = (
                '    <emitter type="area">\n'
                f'      <rgb name="radiance" value="{emission[0]:.6f} '
                f'{emission[1]:.6f} {emission[2]:.6f}"/>\n'
                "    </emitter>\n"
            )
        shapes.append(
            f'  <shape type="obj">\n'
            f'    <string name="filename" value="{obj.name}"/>\n'
            f'    <ref id="mat{mat_id}"/>\n{emitter}'
            "  </shape>"
        )

    mat_blocks = [
        _mat_xml(i, {k: v[i] for k, v in m_np.items()})
        for i in range(m_np["roughness"].shape[0])
    ]

    cam = _np(rs.camera.to_world[b])
    eye = cam[:3, 3]
    fwd = -cam[:3, 2]  # ours looks down -Z
    up = cam[:3, 1]
    target = eye + fwd
    fov = float(_np(rs.camera.fov[b]))

    lights = []
    for i, kind in enumerate(rs.lights.kinds):
        lw = _np(rs.lights.to_world[b, i])
        pos = lw[:3, 3]
        inten = _np(rs.lights.intensity[b, i])
        if int(kind) == 0:  # point
            lights.append(
                '  <emitter type="point">\n'
                f'    <point name="position" x="{pos[0]}" y="{pos[1]}" z="{pos[2]}"/>\n'
                f'    <rgb name="intensity" value="{inten[0]} {inten[1]} {inten[2]}"/>\n'
                "  </emitter>"
            )
        else:  # spot
            lfwd = -lw[:3, 2]
            ltarget = pos + lfwd
            cutoff = float(np.rad2deg(np.arccos(float(rs.lights.cutoff_cos[b, i]))))
            beam = float(np.rad2deg(np.arccos(float(rs.lights.beam_cos[b, i]))))
            lights.append(
                '  <emitter type="spot">\n'
                '    <transform name="to_world">\n'
                f'      <lookat origin="{pos[0]}, {pos[1]}, {pos[2]}" '
                f'target="{ltarget[0]}, {ltarget[1]}, {ltarget[2]}"/>\n'
                "    </transform>\n"
                f'    <rgb name="intensity" value="{inten[0]} {inten[1]} {inten[2]}"/>\n'
                f'    <float name="cutoff_angle" value="{cutoff:.4f}"/>\n'
                f'    <float name="beam_width" value="{beam:.4f}"/>\n'
                "  </emitter>"
            )

    bg = ""
    if rs.background is not None:
        bgv = _np(rs.background)
        if float(np.max(bgv)) > 0:
            bg = (
                '  <emitter type="constant">\n'
                f'    <rgb name="radiance" value="{bgv[0]} {bgv[1]} {bgv[2]}"/>\n'
                "  </emitter>\n"
            )

    xml = f"""<scene version="3.0.0">
  <integrator type="path">
    <integer name="max_depth" value="3"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="{fov:.6f}"/>
    <string name="fov_axis" value="x"/>
    <transform name="to_world">
      <lookat origin="{eye[0]}, {eye[1]}, {eye[2]}" target="{target[0]}, {target[1]}, {target[2]}" up="{up[0]}, {up[1]}, {up[2]}"/>
    </transform>
    <sampler type="independent">
      <integer name="sample_count" value="{spp}"/>
    </sampler>
    <film type="hdrfilm">
      <integer name="width" value="{width}"/>
      <integer name="height" value="{height}"/>
      <rfilter type="box"/>
    </film>
  </sensor>
{chr(10).join(mat_blocks)}
{chr(10).join(shapes)}
{chr(10).join(lights)}
{bg}</scene>
"""
    xml_path = out / f"{name}.xml"
    xml_path.write_text(xml)
    return xml_path
