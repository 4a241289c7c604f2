"""Port parity: the rest of the scene API against the JAX package.

`Curve` (its NURBS points and tangents within 1e-6, its worlds and the
camera it carries in eval mode within 1e-6), `Scene.from_params` (a second
perspective sensor becomes the projector), the stateful eval-mode
`randomize()` over 3 calls and `randomize_batch`, `Mesh.add_animation_func`
and the warnings of a Material's spatial operations.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fireflies_tpu as jff
import fireflies_tpu_torch as tff
from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.utils.nurbs import NURBSCurve as JxCurve
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.utils.nurbs import NURBSCurve as TcCurve

torch.set_num_threads(1)


def _same_params(jp: dict, tp: dict, atol: float = 1e-6) -> None:
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=atol,
                                   err_msg=k)


def _curve_scene(ff, curve_cls, cps, knots, weights):
    scene = ff.Scene()
    curve = scene.add_curve(ff.Curve("curve-path", curve_cls.create(cps, knots, 3, weights),
                                     interp_delta=0.25))
    cam = ff.Transformable("PerspectiveCamera")
    cam.set_world(np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32))
    cam.set_parent(curve)
    scene.set_camera(cam)
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    mesh = ff.Mesh("mesh-tri", verts, np.array([[0, 1, 2]], np.int32))
    mesh.translate_x(-1.0, 1.0)
    scene.add_mesh(mesh)
    scene.eval()
    return scene


def test_curve_matches_jax():
    rng = np.random.default_rng(0)
    cps = rng.normal(size=(7, 3)).astype(np.float32)
    knots = [0, 0, 0, 0, 0.2, 0.5, 0.7, 1, 1, 1, 1]
    weights = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    jc, tc = JxCurve.create(cps, knots, 3, weights), TcCurve.create(cps, knots, 3, weights)
    for t in np.linspace(0.0, 1.0, 11, dtype=np.float32):
        np.testing.assert_allclose(tc.evaluate(torch.tensor(t)).numpy(),
                                   np.asarray(jc.evaluate(jnp.float32(t))), atol=1e-6)
        np.testing.assert_allclose(tc.tangent(torch.tensor(t)).numpy(),
                                   np.asarray(jc.tangent(jnp.float32(t))), atol=1e-6)
    js = _curve_scene(jff, JxCurve, cps, knots, weights)
    ts = _curve_scene(tff, TcCurve, cps, knots, weights)
    jr, tr = js.compile(), ts.compile("cpu")
    for step in range(5):  # wraps past 1 / interp_delta = 4 steps
        _same_params(jr(jax.random.key(0), step), tr(torch.Generator(), step))
    # Straight along +X (tests/test_scene.py): the camera marches with the step.
    line = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float32)
    scene = _curve_scene(tff, TcCurve, line, [0, 0, 0, 0, 1, 1, 1, 1], None)
    fn = scene.compile("cpu")
    xs = [float(fn(torch.Generator(), s)["PerspectiveCamera.to_world"][0, 3]) for s in range(3)]
    assert xs[0] < xs[1] < xs[2]
    assert scene.curves()[0].child() is scene.camera() and scene.camera().relative()


FLAT = {
    "mesh-Cube.vertex_positions": np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
    "mesh-Cube.faces": np.array([[0, 1, 2]], np.int32),
    "PerspectiveCamera.to_world": np.eye(4, dtype=np.float32),
    "PerspectiveCamera.x_fov": 45.0,
    "PerspectiveCamera_1.to_world": np.array([[1, 0, 0, 0.3], [0, 1, 0, 0], [0, 0, 1, 2],
                                              [0, 0, 0, 1]], np.float32),
    "PerspectiveCamera_1.x_fov": 20.0,
    "emit-Spot.intensity.value": np.array([10.0, 10.0, 10.0], np.float32),
    "emit-Spot.cutoff_angle": 35.0,
    "mat-Surface.brdf_0.roughness.value": 0.3,
    "mat-Surface.brdf_0.base_color.value": np.array([0.2, 0.4, 0.6], np.float32),
}


def test_from_params_matches_jax():
    js, ts = jff.Scene.from_params(FLAT), tff.Scene.from_params(FLAT)
    assert ts.camera().name() == "PerspectiveCamera"
    assert ts.projector().name() == "PerspectiveCamera_1"
    assert ts.mesh_at(0) is ts.mesh("mesh-Cube") and ts.light_at(0) is ts.get_light("emit-Spot")
    assert ts.material_at(0) is ts.get_material("mat-Surface")
    assert not any(e.randomizable() for e in (ts.camera(), ts.light_at(0), ts.material_at(0)))
    jp, tp = js.compile()(jax.random.key(0), 0), ts.compile("cpu")(torch.Generator(), 0)
    _same_params(jp, tp)
    np.testing.assert_allclose(tp["mesh-Cube.vertex_positions"].numpy(),
                               FLAT["mesh-Cube.vertex_positions"], atol=1e-6)
    assert float(tp["mat-Surface.roughness"][0]) == pytest.approx(0.3)


def _randomized_vocalfold(scenes):
    scene, _ = scenes.vocalfold(resolution=6, n_anim_frames=3)
    vf = scene.mesh("mesh-Vocalfold")
    vf.scale_x(1.0, 1.5)
    vf.rotate_y(-0.2, 0.2)
    scene.material("mat-Mucosa").add_float_key("roughness", 0.1, 0.9)
    scene.camera().translate([-0.1, 0.0, 0.0], [0.1, 0.05, 0.0])
    scene.eval()
    return scene


def test_stateful_randomize_matches_jax():
    """Eval mode: three randomize() calls sweep steps 0, 1, 2 as JAX's do;
    eval() restarts the sweep.  randomize_batch is compile() a generator,
    and an int seed in train mode draws one reproducible variant."""
    js, ts = _randomized_vocalfold(jx_scenes), _randomized_vocalfold(tc_scenes)
    first = None
    for _ in range(3):
        tp = ts.randomize(device="cpu")
        _same_params(js.randomize(), tp)
        first = tp if first is None else first
    ts.eval()
    for k, v in ts.randomize(device="cpu").items():
        torch.testing.assert_close(v, first[k], rtol=0, atol=0)
    gens = [torch.Generator().manual_seed(s) for s in (4, 5)]
    batch = ts.randomize_batch(gens, steps=[1, 2])
    fn = ts.compile("cpu")
    for params, step in zip(batch, (1, 2)):
        for k, v in fn(torch.Generator(), step).items():
            torch.testing.assert_close(params[k], v, rtol=0, atol=0)
    ts.train()
    a, b = ts.randomize(7, device="cpu"), ts.randomize(torch.Generator().manual_seed(7))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_animation_func_and_material_warnings():
    """A procedural animation f(vertices, t) in eval mode equal to JAX's;
    every spatial operation on a Material warns."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    out = []
    for ff, lib in ((jff, jnp), (tff, torch)):
        scene = ff.Scene()
        mesh = scene.add_mesh(ff.Mesh("mesh-wave", verts, faces))
        mesh.add_animation_func(lambda v, t, lib=lib: v + lib.sin(3.0 * v[:, :1] + t) * 0.1,
                                0.0, 2.0)
        scene.eval()
        out.append(scene)
    jr, tr = out[0].compile(), out[1].compile("cpu")
    for step in (0, 1, 5):
        _same_params(jr(jax.random.key(0), step), tr(torch.Generator(), step))
    mat = tff.Material("mat-x")
    ops = [("rotate_x", (0.0, 1.0)), ("rotate_y", (0.0, 1.0)), ("rotate_z", (0.0, 1.0)),
           ("rotate", ([0, 0, 0], [1, 1, 1])), ("translate_x", (0.0, 1.0)),
           ("translate_y", (0.0, 1.0)), ("translate_z", (0.0, 1.0)),
           ("translate", ([0, 0, 0], [1, 1, 1])), ("set_parent", (tff.Transformable("p"),)),
           ("set_world", (np.eye(4),))]
    for name, args in ops:
        with pytest.warns(UserWarning):
            getattr(mat, name)(*args)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mat.add_float_key("roughness", 0.0, 1.0)
