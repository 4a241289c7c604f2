"""Port parity for the AOV integrators (`render/integrators.py`) on the
vocalfold scene at resolution 12, two variants randomized by the JAX
package and carried over with `interop.from_jax_params`, on a 128x16 film
(one 2048-ray tile) with pixel-centre rays:

  * `render_depth` within 1e-5 relative where both hit, the same hit mask;
    `render_segmentation` / `render_shape_index` equal on every pixel but
    those whose closest hit is a t-tie between faces (depths within 1e-5);
  * `render_depth_differentiable`: the same depth, and the gradient of a
    weighted depth sum with respect to the vertices within 1e-4 relative L2;
  * `render_from_laser` with the 144 uniform beams from the projector:
    valid masks equal, NDC points and depth within 1e-5, the splatted image
    within 1e-5 of its max;
  * `random_depth_maps` over two randomized variants equals the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import integrators as jx_int
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import integrators as tc_int

torch.set_num_threads(1)

W, H = 128, 16
RESOLUTION = 12
CFG = dict(width=W, height=H, spp=1, max_bounces=1)


@pytest.fixture(scope="module")
def setup():
    jx_scene, kw = jx_scenes.vocalfold(resolution=RESOLUTION, n_anim_frames=4)
    jb = JxBridge(jx_scene, **kw)
    jx_randomize = jax.jit(jx_scene.compile())
    keys = jax.random.split(jax.random.key(3), 2)
    jps = [{k: np.asarray(v) for k, v in jx_randomize(k, i).items()} for i, k in enumerate(keys)]
    tb, _, beams = main_path.build("cpu", resolution=RESOLUTION)
    tscene = tb.assemble([from_jax_params(p, "cpu") for p in jps])
    jscenes = [jb.assemble({k: jnp.asarray(v) for k, v in p.items()}) for p in jps]
    return dict(jb=jb, jx_randomize=jx_randomize, jps=jps, tb=tb, tscene=tscene,
                jscenes=jscenes, beams=beams)


def _depth_close(got, ref):
    assert ((got > 0) == (ref > 0)).all() and (ref > 0).mean() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_depth_and_segmentation_match(setup):
    jcfg, tcfg = JxConfig(**CFG), TcConfig(**CFG)
    depth = tc_int.render_depth(setup["tscene"], tcfg).numpy()
    seg = tc_int.render_segmentation(setup["tscene"], tcfg).numpy()
    assert depth.shape == seg.shape == (2, H, W) and seg.dtype == np.int32
    np.testing.assert_array_equal(tc_int.render_shape_index(setup["tscene"], tcfg).numpy(), seg)
    jdepth = jax.jit(jx_int.render_depth, static_argnums=1)
    jseg = jax.jit(jx_int.render_segmentation, static_argnums=1)
    for b, js in enumerate(setup["jscenes"]):
        ref_d, ref_s = np.asarray(jdepth(js, jcfg)), np.asarray(jseg(js, jcfg))
        _depth_close(depth[b], ref_d)
        assert len(np.unique(ref_s)) >= 2
        differ = seg[b] != ref_s
        tie = np.abs(depth[b] - ref_d) <= 1e-5 * ref_d
        assert (tie[differ]).all(), f"{differ.sum()} pixels differ off a t-tie"
        assert differ.mean() <= 1e-3


def test_depth_differentiable_and_vertex_gradient_match(setup):
    jcfg, tcfg = JxConfig(**CFG), TcConfig(**CFG)
    weight = np.random.default_rng(0).uniform(0.5, 1.5, (H, W)).astype(np.float32)
    scene = setup["tscene"]
    verts = scene.geometry.vertices.clone().requires_grad_(True)
    scene = scene.replace(geometry=scene.geometry.replace(vertices=verts))
    depth = tc_int.render_depth_differentiable(scene, tcfg)
    (depth * torch.from_numpy(weight)).sum().backward()

    def jx_objective(v, js):
        d = jx_int.render_depth_differentiable(
            js.replace(geometry=js.geometry.replace(vertices=v)), jcfg)
        return jnp.sum(d * weight), d

    jgrad = jax.jit(jax.grad(jx_objective, has_aux=True))
    for b, js in enumerate(setup["jscenes"]):
        g_ref, d_ref = jgrad(js.geometry.vertices, js)
        _depth_close(depth[b].detach().numpy(), np.asarray(d_ref))
        g_ref, g = np.asarray(g_ref), verts.grad[b].numpy()
        assert np.abs(g_ref).max() > 0 and np.isfinite(g).all()
        assert np.linalg.norm(g - g_ref) <= 1e-4 * np.linalg.norm(g_ref)


def test_render_from_laser_matches(setup):
    jcfg, tcfg = JxConfig(**CFG), TcConfig(**CFG)
    scene, beams = setup["tscene"], setup["beams"]
    pose = scene.projector.to_world
    got = tc_int.render_from_laser(scene, tc_laser.origin_per_ray(pose, beams.shape[0]),
                                   tc_laser.rays_to_world(beams, pose), tcfg, sigma=1.5)
    b_np = beams.numpy()

    @jax.jit
    def jx_laser_aov(js):
        o = jx_laser.origin_per_ray(js.projector.to_world, b_np.shape[0])
        d = jx_laser.rays_to_world(b_np, js.projector.to_world)
        return jx_int.render_from_laser(js, o, d, jcfg, sigma=1.5)

    for b, js in enumerate(setup["jscenes"]):
        ndc_r, depth_r, valid_r, image_r = (np.asarray(x) for x in jx_laser_aov(js))
        ndc, depth, valid, image = (x[b].numpy() for x in got)
        assert valid.sum() > 10
        np.testing.assert_array_equal(valid, valid_r)
        np.testing.assert_allclose(ndc[valid], ndc_r[valid], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(depth, depth_r, rtol=1e-5, atol=1e-5)
        assert image.shape == (H, W) and image.max() > 0
        np.testing.assert_allclose(image, image_r, rtol=0, atol=1e-5 * image_r.max())


def test_random_depth_maps_match(setup):
    jcfg, tcfg = JxConfig(**CFG), TcConfig(**CFG)
    jb, jx_randomize = setup["jb"], setup["jx_randomize"]
    ref = jax.jit(lambda k: jx_int.random_depth_maps(
        lambda kk, s: jb.assemble(jx_randomize(kk, s)), k, jcfg, n_maps=2))(jax.random.key(3))

    def randomize_fn(gens, steps):
        # The reference's draws for the (key, step) pairs its map visits:
        # the fixture's params are those of split(key(3), 2) at steps 0, 1.
        assert steps == [0, 1] and len(gens) == 2
        return setup["tb"].assemble([from_jax_params(p, "cpu") for p in setup["jps"]])

    got = tc_int.random_depth_maps(randomize_fn, main_path.generators([0, 1], "cpu"), tcfg)
    assert got.shape == (2, H, W)
    for b in range(2):
        _depth_close(got[b].numpy(), np.asarray(ref[b]))
