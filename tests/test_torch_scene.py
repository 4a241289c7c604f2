"""Port parity: scene construction, randomization and assembly against the
JAX package on the vocalfold scene (the laser pattern is in
tests/test_torch_lights.py).

Tolerances: topology and eval-mode sweeps exact; assembled scene arrays
and beam parameters to 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.render import SceneBridge as TcBridge

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bridges():
    jx_scene, jx_kw = jx_scenes.vocalfold(resolution=24, n_anim_frames=4)
    tc_scene, tc_kw = tc_scenes.vocalfold(resolution=24, n_anim_frames=4)
    return (jx_scene, JxBridge(jx_scene, **jx_kw)), (tc_scene, TcBridge(tc_scene, **tc_kw))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_vocalfold_topology_and_morton_order(bridges):
    (_, jb), (_, tb) = bridges
    assert tb._faces.shape == (1440, 3)
    np.testing.assert_array_equal(tb._faces, jb._faces)
    np.testing.assert_array_equal(tb._face_mat, jb._face_mat)
    np.testing.assert_array_equal(tb._face_mesh, jb._face_mesh)
    assert tb._lobe_flags == jb._lobe_flags == frozenset()


@pytest.mark.parametrize("train", [False, True])
def test_randomize_matches(bridges, train):
    """Eval mode: the deterministic sweep matches key for key, exactly.
    Train mode: the random streams differ, so the drawn fold mesh must be
    one of the animation frames and everything else the same."""
    (js, _), (ts, _) = bridges
    for s in (js, ts):
        s.train() if train else s.eval()
    jr, tr = js.compile(), ts.compile("cpu")
    for step in range(5):
        jp = jr(jax.random.key(step), step)
        tp = tr(torch.Generator().manual_seed(step), step)
        assert set(jp) == set(tp)
        for k in jp:
            if train and k == "mesh-Vocalfold.vertex_positions":
                frames = [_np(jr(jax.random.key(s), 0)[k]) for s in range(16)]
                assert any(np.array_equal(_np(tp[k]), f) for f in frames)
            else:
                np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)


def test_assemble_from_jax_params(bridges):
    (js, jb), (_, tb) = bridges
    js.train()
    beams_j = jx_laser.generate_uniform_rays(0.0275, 12, 12)
    jp = dict(js.compile()(jax.random.key(3), 0))
    jp.update(jx_laser.rays_to_beam_params(beams_j, 30.0, sigma=10.0, texture_size=(256, 256)))
    js_scene = jb.assemble(jp)
    host = {k: (v if isinstance(v, tuple) else np.asarray(v)) for k, v in jp.items()}
    ts_scene = tb.assemble(from_jax_params(host, "cpu"))
    pairs = {
        "vertices": (ts_scene.geometry.vertices[0], js_scene.geometry.vertices),
        "faces": (ts_scene.geometry.faces, js_scene.geometry.faces),
        "face_mat": (ts_scene.geometry.face_mat, js_scene.geometry.face_mat),
        "light.to_world": (ts_scene.lights.to_world[0], js_scene.lights.to_world),
        "light.intensity": (ts_scene.lights.intensity[0], js_scene.lights.intensity),
        "light.cutoff_cos": (ts_scene.lights.cutoff_cos[0], js_scene.lights.cutoff_cos),
        "light.beam_cos": (ts_scene.lights.beam_cos[0], js_scene.lights.beam_cos),
        "camera.to_world": (ts_scene.camera.to_world[0], js_scene.camera.to_world),
        "camera.fov": (ts_scene.camera.fov[0], js_scene.camera.fov),
        "proj.to_world": (ts_scene.projector.to_world[0], js_scene.projector.to_world),
        "proj.fov": (ts_scene.projector.fov[0], js_scene.projector.fov),
        "proj.scale": (ts_scene.projector.scale[0], js_scene.projector.scale),
        "proj.beams": (ts_scene.projector.beams_ndc[0], js_scene.projector.beams_ndc),
        "proj.sigma": (ts_scene.projector.beam_sigma[0], js_scene.projector.beam_sigma),
        "proj.color": (ts_scene.projector.beam_color[0], js_scene.projector.beam_color),
        "background": (ts_scene.background, js_scene.background),
    }
    for field in ("base_color", "roughness", "metallic", "specular", "spec_tint", "ior",
                  "emission", "spec_trans", "anisotropic"):
        pairs["mat." + field] = (getattr(ts_scene.materials, field)[0],
                                 getattr(js_scene.materials, field))
    for name, (ours, theirs) in pairs.items():
        np.testing.assert_allclose(_np(ours), _np(theirs), rtol=1e-6, atol=1e-6, err_msg=name)
    assert ts_scene.lights.kinds == tuple(np.asarray(js_scene.lights.kinds).tolist())
    assert ts_scene.projector.beam_hw == js_scene.projector.beam_hw
    assert ts_scene.materials.flags == js_scene.materials.flags
