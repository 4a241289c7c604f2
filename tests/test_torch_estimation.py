"""Port parity for `initialize_laser` (estimation/laser_estimation.py) in
its four modes, on the vocalfold scene at resolution 8 with a 128x32
sampling film:

  * GRID within 1e-6 of the reference's beams;
  * RANDOM with the reference's draws given to `generate_random_rays`
    (1e-6);
  * POISSON with each package's default Bridson (the native library's
    std::mt19937_64 stream on both sides): the same beams (1e-6);
  * SMARTY on the reference's randomized variants (carried over with
    `interop.from_jax_params`): the depth maps within 1e-5 relative with
    the same hit mask; from the reference's maps on, Bridson's radius map
    within 1e-5 relative, each package's default (native) Bridson placing
    the same points (1e-4 px) in the same pixels, and the beams through
    the chosen pixels within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from fireflies_tpu import sampling as jx_sampling
from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.estimation import laser_estimation as jx_le
from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import integrators as jx_int
from fireflies_tpu_torch import sampling as tc_sampling
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.estimation import LaserConfig, initialize_laser
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import SceneBridge as TcBridge
from fireflies_tpu_torch.render import integrators as tc_int

torch.set_num_threads(1)

W, H = 128, 32
CFG = dict(n_beams=40, n_depthmaps=3, image_size=(W, H), smarty_min_radius=2.0,
           smarty_max_radius=8.0)


@pytest.fixture(scope="module")
def scenes():
    jscene, kw = jx_scenes.vocalfold(resolution=8, n_anim_frames=2)
    tscene, tkw = tc_scenes.vocalfold(resolution=8, n_anim_frames=2)
    return jscene, JxBridge(jscene, **kw), tscene, TcBridge(tscene, **tkw)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["GRID", "RANDOM", "POISSON"])
def test_initialize_laser_matches(mode, scenes, monkeypatch):
    jscene, jbridge, tscene, tbridge = scenes
    # The reference's RANDOM draws (its default key, laser.py's uniform).
    ndc = np.asarray(jax.random.uniform(jax.random.key(0), (CFG["n_beams"], 2), minval=-1.0,
                                        maxval=1.0))
    draw = tc_laser.generate_random_rays
    monkeypatch.setattr(tc_laser, "generate_random_rays",
                        lambda gen, n, fov: draw(gen, n, fov, ndc=torch.from_numpy(ndc)))
    ref = jx_le.initialize_laser(jscene, jbridge, jx_le.LaserConfig(**CFG), mode=mode,
                                 projector_fov=25.0)
    got = initialize_laser(tscene, tbridge, LaserConfig(**CFG), mode=mode, projector_fov=25.0,
                           device="cpu")
    assert got.fov() == 25.0 and got.transformable() is tscene.projector()
    assert got.local_rays().shape[0] == {"GRID": 36, "RANDOM": 40}.get(mode, 56)
    _close(got.local_rays(), ref.local_rays(), 1e-6)


def _recorder(fn, calls):
    def record(*args, **kw):
        calls.append((args, fn(*args, **kw)))
        return calls[-1][1]

    return record


def test_smarty_matches(scenes, monkeypatch):
    jscene, jbridge, tscene, tbridge = scenes
    maps_ref, bridson_ref, bridson_got = [], [], []
    monkeypatch.setattr(jx_sampling, "bridson", _recorder(jx_sampling.bridson, bridson_ref))
    monkeypatch.setattr(tc_sampling, "bridson", _recorder(tc_sampling.bridson, bridson_got))
    monkeypatch.setattr(jx_int, "random_depth_maps", _recorder(jx_int.random_depth_maps, maps_ref))
    rcfg = dict(width=W, height=H, spp=1, max_bounces=1)
    ref = jx_le.initialize_laser(jscene, jbridge, jx_le.LaserConfig(**CFG), mode="SMARTY",
                                 key=jax.random.key(0), render_config=JxConfig(**rcfg))

    # The reference's variants: split(split(key)[0], n) at steps 0..n-1,
    # and key(0) at step 0.
    randomize = jax.jit(jscene.compile())
    keys = jax.random.split(jax.random.split(jax.random.key(0))[0], CFG["n_depthmaps"])

    def carried(pairs):
        return tbridge.assemble([from_jax_params(
            {k: np.asarray(v) for k, v in randomize(key, step).items()}, "cpu")
            for key, step in pairs])

    variants = (carried([(k, i) for i, k in enumerate(keys)]), carried([(jax.random.key(0), 0)]))
    # The port renders its own maps; the rest of its pipeline takes the
    # reference's, since the maps' variance amplifies their 1e-5 relative
    # difference (a few maps of nearly equal depth) beyond Bridson's ulps.
    depth_ref = np.asarray(maps_ref[0][1])
    maps = []
    render = tc_int.render_depth
    monkeypatch.setattr(tc_int, "render_depth", lambda *a: maps.append(render(*a))
                        or torch.from_numpy(depth_ref))
    info = {}
    got = initialize_laser(tscene, tbridge, LaserConfig(**CFG), mode="SMARTY", device="cpu",
                           render_config=TcConfig(**rcfg), variants=variants, info=info)
    depth = maps[0].numpy()
    assert depth.shape == (3, H, W) and (depth_ref > 0).mean() > 0.5
    np.testing.assert_array_equal(depth > 0, depth_ref > 0)
    np.testing.assert_allclose(depth, depth_ref, rtol=1e-5, atol=0)
    assert info["constraint"].mean() > 0.1 and info["depth_maps_s"] > 0 and info["bridson_s"] > 0

    # Bridson's input (the radius map) and its points.
    (radius_ref, *_), (n_ref, pts_ref) = bridson_ref[0]
    (radius, *_), (n, pts) = bridson_got[0]
    np.testing.assert_allclose(radius, np.asarray(radius_ref), rtol=1e-5, atol=0)
    # The radius map's ulps move the points by ulps, not the decisions: the
    # same count, the same pixels.
    assert n == n_ref > 50
    np.testing.assert_array_equal(np.floor(pts), np.floor(pts_ref))
    np.testing.assert_allclose(pts, pts_ref, rtol=0, atol=1e-4)
    # One beam a chosen pixel, in the same order.
    rays, rays_ref = got.local_rays(), np.asarray(ref.local_rays())
    assert rays.shape == rays_ref.shape and rays.shape[0] > 10
    np.testing.assert_allclose(rays.numpy(), rays_ref, rtol=1e-5, atol=1e-5)
    assert len(set(info["chosen"].tolist())) == rays.shape[0]
