"""Port parity: Mitsuba XML scenes (`utils/mitsuba_xml.py`,
`utils/mitsuba_export.py`) against the JAX package.

`load_mitsuba_xml`'s params and meta equal JAX's on tests/test_mitsuba_xml.py's
XML and on the exported tools/parity_scenes/vocalfold.xml; both packages
keep the reference's two loader faults (vocalfold.xml's `<ref>`s bind no
material; the x=/y=/z= point light of cornell_like.xml and hello_world.xml
raises); `export_render_scene` writes JAX's XML text and OBJ bytes
for a variant carried over by `interop.from_jax_params`; a CPU render of
the loaded vocalfold.xml (the `xml` shape at 128x16) is finite and hits
more than 90% of its pixels.
"""

import jax
import numpy as np
import pytest
import torch

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.utils import mitsuba_export as jx_export
from fireflies_tpu.utils import mitsuba_xml as jx_xml
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.render import SceneBridge as TcBridge
from fireflies_tpu_torch.render import render_depth
from fireflies_tpu_torch.utils import mitsuba_export as tc_export
from fireflies_tpu_torch.utils import mitsuba_xml as tc_xml
from test_mitsuba_xml import XML

torch.set_num_threads(1)
PARITY = "tools/parity_scenes"


def _same(a, b, what) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)) and not isinstance(a[0], (int, float)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b and type(a) is type(b), what


def test_load_mitsuba_xml_matches_jax(tmp_path):
    (tmp_path / "tri.obj").write_text("v -1 -1 -1\nv 1 -1 -1\nv 0 1 -1\nf 1 2 3\n")
    (tmp_path / "scene.xml").write_text(XML)
    for path in (tmp_path / "scene.xml", f"{PARITY}/vocalfold.xml"):
        _xml_parity(path)


def _xml_parity(path) -> None:
    name = str(path)
    _same(tc_xml.load_mitsuba_xml(path), jx_xml.load_mitsuba_xml(path), name)
    (ts, tkw, tmeta), (js, jkw, jmeta) = (tc_xml.scene_from_mitsuba_xml(path),
                                          jx_xml.scene_from_mitsuba_xml(path))
    _same(tkw, jkw, "bridge kwargs")
    assert ts.mesh_material_binding() == js.mesh_material_binding()
    assert [(li.name(), li.kind()) for li in ts.lights()] == [(li.name(), li.kind())
                                                             for li in js.lights()]
    jp = js.compile()(jax.random.key(0), 0)
    tp = ts.compile("cpu")(torch.Generator(), 0)
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)
    if name.endswith("vocalfold.xml"):
        # The reference's fault, kept: the shapes' <ref id="mat0|1"/> are
        # not followed, so nothing is bound and every face takes mat0.
        assert ts.mesh_material_binding() == {} == js.mesh_material_binding()
        assert [m.name() for m in ts.materials()] == ["mat0", "mat1"]


def test_point_light_files_raise_in_both():
    """The reference's other fault, kept: the exporter writes a point light
    as `<point name="position" x= y= z=/>`, which has no `value`, so
    reading cornell_like.xml and hello_world.xml raises AttributeError in
    both packages."""
    for name in ("cornell_like.xml", "hello_world.xml"):
        for loader in (tc_xml.load_mitsuba_xml, jx_xml.load_mitsuba_xml):
            with pytest.raises(AttributeError):
                loader(f"{PARITY}/{name}")


def test_export_matches_jax(tmp_path):
    """One JAX-randomized variant each of hello_world (a point light) and
    vocalfold (a spot), assembled in both packages (the port's from
    `interop.from_jax_params`): the same XML text and OBJ bytes."""
    for build in ("hello_world", "vocalfold"):
        _export_parity(tmp_path / build, build)


def _export_parity(tmp_path, build) -> None:
    kwargs = {"resolution": 6, "n_anim_frames": 2} if build == "vocalfold" else {}
    js, jkw = getattr(jx_scenes, build)(**kwargs)
    ts, tkw = getattr(tc_scenes, build)(**kwargs)
    params = {k: np.asarray(v) for k, v in js.compile()(jax.random.key(3), 0).items()}
    jrs = JxBridge(js, **jkw).assemble(params)
    trs = TcBridge(ts, **tkw).assemble([from_jax_params(params, "cpu")])
    jx_path = jx_export.export_render_scene(jrs, tmp_path / "jx", name=build, spp=16)
    tc_path = tc_export.export_render_scene(trs, tmp_path / "tc", name=build, spp=16)
    assert tc_path.read_text() == jx_path.read_text()
    objs = sorted(p.name for p in (tmp_path / "jx").glob("*.obj"))
    assert objs and objs == sorted(p.name for p in (tmp_path / "tc").glob("*.obj"))
    for obj in objs:
        assert (tmp_path / "tc" / obj).read_bytes() == (tmp_path / "jx" / obj).read_bytes()


def test_xml_shape_renders_on_cpu():
    bridge, randomize, beams, cfg = main_path.build_shape("xml", "cpu", 128)
    cfg = cfg.replace(width=128, height=16)
    img = main_path.render_batch(bridge, randomize, beams, [0, 1], cfg)
    assert img.shape == (2, 16, 128, 3) and bool(torch.isfinite(img).all())
    assert float(img.max()) > 0
    gens = main_path.generators([0, 1], "cpu")
    depth = render_depth(main_path.scene_batch(bridge, randomize, beams, gens), cfg)
    assert float((depth > 0).float().mean()) > 0.9
    assert bridge._faces.shape == (1440, 3)
