"""Port parity: YAML scene files (`utils/io.py`'s reader and writer,
`scene_io.py`) against PyYAML and the JAX package.

The port's reader gives what `yaml.safe_load` gives on `yaml.safe_dump`'s
output and on hand-written files (flow lists, comments, quoting); PyYAML
reads the port's writer's output back equal; `load_scene` of one file in
both packages gives the same eval-mode params over 3 steps within 1e-6.
"""

from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from fireflies_tpu import scene_io as jx_scene_io
from fireflies_tpu.assets import procedural as jx_procedural
from fireflies_tpu_torch import scene_io as tc_scene_io
from fireflies_tpu_torch.utils import io as tc_io

SCENE_YAML = {
    "camera": {"position": [0, 0.8, 2.5], "look_at": [0, 0, 0], "fov": 45,
               "randomize": {"translate_x": [-0.1, 0.1], "fov": [40, 60]}},
    "meshes": [
        {"name": "mesh-Cube", "primitive": "box", "size": 0.5, "material": "mat-Cube",
         "randomize": {"rotate_y": [-3.14, 3.14]}},
        {"name": "mesh-Floor", "primitive": "plane", "size": 3.0, "position": [0, -0.6, 0],
         "material": "mat-Floor"},
    ],
    "materials": [
        {"name": "mat-Cube", "base_color": [0.8, 0.3, 0.25],
         "randomize": {"roughness": [0.1, 0.9]}},
        {"name": "mat-Floor", "base_color": [0.6, 0.6, 0.6]},
    ],
    "lights": [{"name": "light-Main", "kind": "point", "position": [1.5, 2, 2],
                "intensity": [12, 12, 12], "randomize": {"intensity_scalar": [5, 25]}}],
    "background": [0, 0, 0],
}

# Scalars and layouts that a naive reader gets wrong.
TRICKY = {
    "numbers": [1, -2, 0.5, 1e-05, -3.25e10, 1.0e+5, float("inf"), 8],
    "strings": ["1.5", "yes", "", "x: y", "it's", "a #b", "a\nb", "word " * 20, "null", "é"],
    "nested": [[1, [2, 3]], {"k": [{"x": None, "y": True}]}, [], {}],
    "3": "int-looking key",
}

HAND_WRITTEN = """\
# a comment line
camera:
  position: [0, 0.8, 2.5]   # flow list
  fov: 45
  randomize:
    scale: [[0.5, 0.5, 0.5], [2, 2, 2]]
    flags: {a: 1, 'b': "two\\n"}
numbers: [1e5, 1.0e5, 1.0e+5, 010, 0x1F, .5, +1, 1_000, ~, Yes, off]
list:
  - - 1
    - 2
  -
    key: value
text: a plain scalar
  continued here
quoted: 'one

  two'
"""


def test_reader_matches_pyyaml():
    docstring = Path(jx_scene_io.__file__).read_text().split("```yaml\n")[1].split("```")[0]
    laser_json = ('{"rays": [\n  [0.1, -0.2, 1.0e-05],\n  [1.0, 2.0, 3.0]\n], "fov": 30.0, '
                  '"near_clip": 0.01, "far_clip": 1000.0}\n')
    texts = [yaml.safe_dump(SCENE_YAML), yaml.safe_dump(TRICKY), docstring, HAND_WRITTEN,
             laser_json, yaml.safe_dump(SCENE_YAML, default_flow_style=None),
             yaml.safe_dump(TRICKY, default_flow_style=True)]
    for text in texts:
        assert tc_io.yaml_loads(text) == yaml.safe_load(text), text
    assert tc_io.yaml_loads(yaml.safe_dump(SCENE_YAML)) == SCENE_YAML


def test_writer_reads_back_in_pyyaml(tmp_path):
    for data in (SCENE_YAML, TRICKY):
        text = tc_io.yaml_dumps(data)
        back = yaml.safe_load(text)
        assert back == data, text
        assert tc_io.yaml_loads(text) == back
    assert tc_io.yaml_dumps(SCENE_YAML) == yaml.safe_dump(SCENE_YAML)
    tc_io.write_yaml({"a": np.float32(0.5), "b": np.arange(3)}, tmp_path / "c.yml")
    assert yaml.safe_load((tmp_path / "c.yml").read_text()) == {"a": 0.5, "b": [0, 1, 2]}
    assert tc_io.read_config_yaml(tmp_path / "c.yml") == {"a": 0.5, "b": [0, 1, 2]}


def _description(tmp_path) -> Path:
    """A scene with every block: an animated vocalfold primitive (resolution
    6, OBJ frames), a box, a placed plane, a spot with a grey intensity, a
    randomized camera and a projector; written by PyYAML."""
    desc = {
        **SCENE_YAML,
        "meshes": SCENE_YAML["meshes"] + [
            {"name": "mesh-Fold", "primitive": "vocalfold", "resolution": 6,
             "material": "mat-Cube", "animation": {"obj_dir": "frames"},
             "randomize": {"scale_x": [1.0, 1.5], "rotate": [[0, -0.2, 0], [0, 0.2, 0.1]]}}],
        "lights": SCENE_YAML["lights"] + [
            {"name": "emit-Spot", "kind": "spot", "position": [0, 0, 1.95], "look_at": [0, 0, 0],
             "intensity": [12, 12, 12], "cutoff_angle": 40.0,
             "randomize": {"intensity_scalar": [5, 25]}}],
        "projector": {"position": [0.35, 0, 1.9], "look_at": [0, 0, 0], "fov": 30,
                      "scale": 20},
    }
    verts, faces, _ = jx_procedural.make_vocalfold(resolution=6)
    frames = jx_procedural.vocalfold_animation_frames(3, resolution=6) - verts.mean(0)
    (tmp_path / "frames").mkdir()
    for i, frame in enumerate(frames):
        tc_io.save_obj(tmp_path / "frames" / f"frame_{i:03d}.obj", frame, faces)
    path = tmp_path / "scene.yml"
    path.write_text(yaml.safe_dump(desc))
    return path


def test_load_scene_matches_jax(tmp_path):
    """The same file in both packages: bridge kwargs equal, every param of
    3 eval-mode steps within 1e-6; the port's own writer's file loads to
    the same scene."""
    path = _description(tmp_path)
    (js, jkw), (ts, tkw) = jx_scene_io.load_scene(path), tc_scene_io.load_scene(path)
    desc = tc_io.read_config_yaml(path)
    tc_scene_io.save_scene_description(desc, tmp_path / "again.yml")
    ts2, tkw2 = tc_scene_io.load_scene(tmp_path / "again.yml")
    assert jkw == tkw == tkw2
    assert [m.name() for m in ts.meshes()] == [m.name() for m in js.meshes()]
    assert ts.mesh_material_binding() == js.mesh_material_binding()
    for s in (js, ts, ts2):
        s.eval()
    jr, tr, tr2 = js.compile(), ts.compile("cpu"), ts2.compile("cpu")
    for step in range(3):
        jp = jr(jax.random.key(0), step)
        tp, tp2 = tr(torch.Generator(), step), tr2(torch.Generator(), step)
        assert set(jp) == set(tp) == set(tp2)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(tp2[k].numpy(), tp[k].numpy(), err_msg=k)


def test_mesh_placement():
    """tests/test_scene_io_aux.py's placement case: a box at x = 5."""
    scene, _ = tc_scene_io.load_scene({
        "meshes": [{"name": "mesh-S", "primitive": "box", "size": 1.0, "position": [5, 0, 0]}],
        "camera": {"position": [0, 0, 4]}})
    params = scene.compile("cpu")(torch.Generator(), 0)
    np.testing.assert_allclose(params["mesh-S.vertex_positions"].mean(0).numpy(), [5, 0, 0],
                               atol=1e-4)
    assert scene.camera().name() == "PerspectiveCamera"
