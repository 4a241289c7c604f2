"""Port parity for films of any size and for the band render
(render/rays.py, render/pathtracer.py, the AOV integrators):

  * `camera_rays` against the JAX package's at pixel centres and with the
    reference's jitter injected, in band mode too (1e-6);
    `camera_rays_tiled` against the reference's on films that do not
    divide into 128x16 tiles (24x24, 200x120, 500x36: the permutation
    route, the same order and inv_perm), and `unpermute_rows` /
    `permute_rows` undoing each other there and on a film that divides;
  * the vocalfold scene (resolution 6) rendered deterministically (pixel
    centres, one bounce) at 24x24 and 200x120 through `render_rgb`, against
    the reference's `trace_rays` on its tile-major rays: within 1e-4 of the
    image max on >= 99.9% of pixels, every exception a primary-hit tie;
  * bands: at pixel centres and one bounce nothing is drawn, so the bands
    of `render_rgb(film_y0=, film_full_height=)` concatenated equal the
    whole film, on the arithmetic route (128x64 in 4 bands of 16 rows) and
    the permutation route (100x60 in 4 bands of 15), also through
    `ray_chunk` and `shared_primary`; with `reparam` a band raises;
  * SMARTY at a 100x100 `image_size`: its depth maps of the reference's
    variants within 1e-5 relative of the reference's, and its beams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.estimation import laser_estimation as jx_le
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import integrators as jx_int
from fireflies_tpu.render import intersect as jx_intersect
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.estimation import LaserConfig, initialize_laser
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import SceneBridge as TcBridge
from fireflies_tpu_torch.render import integrators as tc_int
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render import rays as tc_rays
from fireflies_tpu_torch.render import render_rgb

torch.set_num_threads(1)

RES = 6  # vocalfold resolution


@pytest.fixture(scope="module")
def scenes():
    """(jax_assemble, torch_assemble): the vocalfold scene at RES from one
    set of JAX-randomized parameters, with the uniform beam pattern."""
    jx_scene, kw = jx_scenes.vocalfold(resolution=RES, n_anim_frames=2)
    jb = JxBridge(jx_scene, **kw)
    tb, _, _ = main_path.build("cpu", resolution=RES)
    jp = {k: np.asarray(v) for k, v in jax.jit(jx_scene.compile())(jax.random.key(5), 0).items()}
    beams = np.array(jx_laser.generate_uniform_rays(0.0275, 12, 12))
    jp.update({k: np.asarray(v) if not isinstance(v, tuple) else v for k, v in
               jx_laser.rays_to_beam_params(jnp.asarray(beams), 30.0, sigma=10.0,
                                            texture_size=(256, 256)).items()})

    def jx_assemble():
        return jb.assemble({k: v if isinstance(v, tuple) else jnp.asarray(v)
                            for k, v in jp.items()})

    def tc_assemble(copies=1):
        return tb.assemble([from_jax_params(jp, "cpu")] * copies)

    return jx_assemble, tc_assemble


def test_camera_rays_and_orders_match(scenes, monkeypatch):
    jx_assemble, tc_assemble = scenes
    jcam, tcam = jx_assemble().camera, tc_assemble().camera
    w, h = 24, 20
    o_j, d_j = jx_rays.camera_rays(jcam, w, h)
    o_t, d_t = tc_rays.camera_rays(tcam, w, h)
    assert o_t.shape == d_t.shape == (1, w * h, 3)
    np.testing.assert_allclose(d_t[0].numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(o_t[0].numpy(), np.asarray(o_j), rtol=0, atol=1e-6)
    # The reference's jitter injected, in band mode (rows 40..59 of 100).
    key = jax.random.key(3)
    jit = torch.from_numpy(np.asarray(jax.random.uniform(key, (w * h, 2))))
    monkeypatch.setattr(tc_rays, "uniform", lambda gens, shape, device: jit[None])
    _, d_j = jx_rays.camera_rays(jcam, w, h, key=key, y_offset=40, full_height=100)
    _, d_t = tc_rays.camera_rays(tcam, w, h, gens=[None], y_offset=40, full_height=100)
    np.testing.assert_allclose(d_t[0].numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
    monkeypatch.undo()

    for w, h in ((24, 24), (200, 120), (500, 36)):
        o_j, d_j, inv_j = jx_rays.camera_rays_tiled(jcam, w, h, key=None)
        o_t, d_t, inv_t = tc_rays.camera_rays_tiled(tcam, w, h)
        np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
        np.testing.assert_allclose(d_t[0].numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
        rows = tc_rays.camera_rays(tcam, w, h)[1]
        torch.testing.assert_close(tc_rays.unpermute_rows(d_t, inv_t, w, h), rows,
                                   rtol=0, atol=0)
        torch.testing.assert_close(tc_rays.permute_rows(rows, w, h), d_t, rtol=0, atol=0)
        assert torch.equal(tc_rays._tile_perm(w, h, torch.device("cpu"))[1], inv_t)
    # A film that divides keeps the arithmetic route: no inv_perm, reshapes.
    _, d_t, inv_t = tc_rays.camera_rays_tiled(tcam, 256, 32)
    assert inv_t is None and tc_rays._tile_perm(256, 32, torch.device("cpu")) is None
    rows = tc_rays.camera_rays(tcam, 256, 32)[1]
    torch.testing.assert_close(tc_rays.unpermute_rows(d_t, None, 256, 32), rows, rtol=0, atol=0)
    torch.testing.assert_close(tc_rays.permute_rows(rows, 256, 32), d_t, rtol=0, atol=0)


def test_odd_film_renders_match(scenes):
    for film in ((24, 24), (200, 120)):
        _check_render(scenes, *film)


def _check_render(scenes, w, h):
    jx_assemble, tc_assemble = scenes
    jscene = jx_assemble()
    cfg_j = JxConfig(width=w, height=h, spp=1, max_bounces=1, static_geometry=True)
    o, d, inv = jx_rays.camera_rays_tiled(jscene.camera, w, h, key=None)
    img_j = np.asarray(jx_rays.unpermute_rows(jax.jit(
        lambda o, d: jx_pt.trace_rays(jscene, o, d, jax.random.key(0), cfg_j,
                                      primary_origin=jscene.camera.to_world[:3, 3]))(o, d),
        inv, w, h))
    tscene = tc_assemble()
    img_t = render_rgb(tscene, None, TcConfig(width=w, height=h, spp=1, max_bounces=1,
                                              static_geometry=True))[0].reshape(-1, 3).numpy()
    assert img_t.shape == img_j.shape == (w * h, 3) and img_j.max() > 0
    bad = np.abs(img_t - img_j).max(axis=1) > 1e-4 * np.abs(img_j).max()
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} pixels differ"
    if bad.any():  # each exception must be a tie on the primary hit
        o_r, d_r = jx_rays.camera_rays(jscene.camera, w, h)
        ref = jx_intersect.intersect_brute(o_r, d_r, jscene.geometry)
        ot, dt = tc_rays.camera_rays(tscene.camera, w, h)
        ours = tc_intersect.closest_hit(ot, dt, tscene.geometry,
                                        shared_origin=tscene.camera.to_world[:, :3, 3])
        assert np.all(np.asarray(ref.prim)[bad] != ours.prim[0].numpy()[bad])
        np.testing.assert_allclose(ours.t[0].numpy()[bad], np.asarray(ref.t)[bad], rtol=1e-5)


def test_bands_concatenate_to_the_whole_film(scenes):
    _, tc_assemble = scenes
    scene = tc_assemble(copies=2)
    with torch.no_grad():
        for w, h, band, extra in ((128, 64, 16, {}), (100, 60, 15, {}),
                                  (100, 60, 15, dict(ray_chunk=700)),
                                  (100, 60, 15, dict(shared_primary=True))):
            cfg = TcConfig(width=w, height=h, spp=1, max_bounces=1, static_geometry=True,
                           **extra)
            whole = render_rgb(scene, None, cfg)
            parts = [render_rgb(scene, None, cfg.replace(height=band), film_y0=y0,
                                film_full_height=h) for y0 in range(0, h, band)]
            assert whole.shape == (2, h, w, 3) and whole.max() > 0
            torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        render_rgb(scene, main_path.generators([0, 1], "cpu"),
                   TcConfig(width=24, height=8, reparam=True), film_y0=8, film_full_height=24)


def test_smarty_at_100x100(monkeypatch):
    jscene, kw = jx_scenes.vocalfold(resolution=RES, n_anim_frames=2)
    tscene, tkw = tc_scenes.vocalfold(resolution=RES, n_anim_frames=2)
    jbridge, tbridge = JxBridge(jscene, **kw), TcBridge(tscene, **tkw)
    cfg = dict(n_beams=40, n_depthmaps=2, image_size=(100, 100), smarty_min_radius=2.0,
               smarty_max_radius=8.0)
    maps_ref = []
    draw = jx_int.random_depth_maps
    monkeypatch.setattr(jx_int, "random_depth_maps",
                        lambda *a, **k: maps_ref.append(draw(*a, **k)) or maps_ref[-1])
    rcfg = dict(width=100, height=100, spp=1, max_bounces=1)
    jx_le.initialize_laser(jscene, jbridge, jx_le.LaserConfig(**cfg), mode="SMARTY",
                           key=jax.random.key(0), render_config=JxConfig(**rcfg))
    randomize = jax.jit(jscene.compile())
    keys = jax.random.split(jax.random.split(jax.random.key(0))[0], cfg["n_depthmaps"])

    def carried(pairs):
        return tbridge.assemble([from_jax_params(
            {k: np.asarray(v) for k, v in randomize(key, step).items()}, "cpu")
            for key, step in pairs])

    variants = (carried([(k, i) for i, k in enumerate(keys)]), carried([(jax.random.key(0), 0)]))
    maps = []
    render = tc_int.render_depth
    monkeypatch.setattr(tc_int, "render_depth", lambda *a: maps.append(render(*a)) or maps[-1])
    got = initialize_laser(tscene, tbridge, LaserConfig(**cfg), mode="SMARTY", device="cpu",
                           variants=variants)
    depth, depth_ref = maps[0].numpy(), np.asarray(maps_ref[0])
    assert depth.shape == depth_ref.shape == (2, 100, 100) and (depth_ref > 0).mean() > 0.5
    np.testing.assert_array_equal(depth > 0, depth_ref > 0)
    np.testing.assert_allclose(depth, depth_ref, rtol=1e-5, atol=0)
    rays = got.local_rays()
    assert rays.shape[0] > 10 and torch.isfinite(rays).all()
    torch.testing.assert_close(rays.norm(dim=-1), torch.ones(rays.shape[0]), rtol=0, atol=1e-5)
