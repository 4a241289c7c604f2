"""The unculled routes end to end (`tile_cull=False`, the reference's
FF_NO_TILE_CULL=1): the dispatcher's routes against the brute-force scans
(prims equal, t within 1e-5 relative, any-hit masks exact), and the
one-bounce render on both unculled routes: vocalfold (1440 faces) on a
128x32 film from the same randomized parameters (`from_jax_params`),
pixel-centre rays, within 1e-4 of the image max on >= 99.9% of pixels as
tests/test_torch_render.py holds the culled route; the beam gradient finite
and within 1e-5 relative L2 of the culled route's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import ORIGIN, _counting, _scene, _t

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import rays as tc_rays
from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_general_culled as tc_gculled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel
from fireflies_tpu_torch.render.cuda import intersect_stream as tc_stream
from fireflies_tpu_torch.render.types import Geometry

torch.set_num_threads(2)

W, H = 128, 32


# The plain versions each route's wrappers reach on CPU tensors, by route.
_CULLED = {"resident": [(tc_culled, "intersect_culled_packed_plain"),
                        (tc_gculled, "intersect_general_culled_packed_plain")],
           "streamed": [(tc_stream, "stream_culled_packed_plain")]}


_UNCULLED = {"resident": [(tc_kernel, "intersect_shared_packed_plain"),
                          (tc_kernel, "intersect_packed_plain")],
             "streamed": [(tc_stream, "stream_packed_plain")]}


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_dispatcher_routes_without_tile_culling(monkeypatch, route):
    """Resident: with the culled general threshold at 0 (the 4096-8192-face
    band), tile_cull=False sends shared-origin rays to B6 and per-ray
    origins to B3, never B5.  Streamed (RESIDENT_MAX_FACES at 0): B7s and
    B7g, with the attributes gathered.  Results agree with the brute-force
    scans; tile_cull=True keeps the culled kernels."""
    verts, faces, face_mat, o, d, tmax = _scene(26, n_variants=1)
    geo = Geometry(vertices=_t(verts), faces=_t(faces, torch.long),
                   face_mat=_t(face_mat, torch.long), face_mesh=torch.zeros(300, dtype=torch.long))
    ot, dt, tm = _t(o), _t(d), _t(tmax)
    origin = _t(ORIGIN)[None]
    o_s = origin[:, None, :].expand_as(dt)
    monkeypatch.setattr(tc_intersect, "GEN_CULL_MIN_FACES", 0)
    if route == "streamed":
        monkeypatch.setattr(tc_intersect, "RESIDENT_MAX_FACES", 0)
    calls = {}
    for module, name in [*_CULLED[route], *_UNCULLED[route], (tc_intersect, "_attrs_fallback")]:
        calls[name] = _counting(monkeypatch, module, name)

    ref = tc_intersect.intersect_brute(ot, dt, geo, t_max=tm)
    ref_s = tc_intersect.intersect_brute(o_s, dt, geo, t_max=tm)
    for rays, kw, want in ((ot, {}, ref), (o_s, dict(shared_origin=origin), ref_s)):
        via = tc_intersect.closest_hit(rays, dt, geo, t_max=tm, emit_attrs=True, tile_cull=False,
                                       **kw)
        np.testing.assert_array_equal(via.prim.numpy(), want.prim.numpy())
        np.testing.assert_allclose(via.t.numpy(), want.t.numpy(), rtol=1e-5, atol=1e-6)
        gathered = tc_intersect._attrs_fallback(via, geo)
        for a, b in zip((via.nx, via.ny, via.nz, via.mat),
                        (gathered.nx, gathered.ny, gathered.nz, gathered.mat)):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(
            tc_intersect.occluded_any(rays, dt, geo, t_max=tm, tile_cull=False, **kw).numpy(),
            tc_intersect.occluded(rays, dt, geo, t_max=tm).numpy())
    n_unculled = sum(len(calls[name]) for _, name in _UNCULLED[route])
    assert n_unculled == 4 and not any(calls[name] for _, name in _CULLED[route])
    assert len(calls["_attrs_fallback"]) == 4  # two closest hits, two checks above

    for rays, kw in ((ot, {}), (o_s, dict(shared_origin=origin))):
        tc_intersect.closest_hit(rays, dt, geo, t_max=tm, **kw)
        tc_intersect.occluded_any(rays, dt, geo, t_max=tm, **kw)
    assert sum(len(calls[name]) for _, name in _CULLED[route]) == 4
    assert sum(len(calls[name]) for _, name in _UNCULLED[route]) == n_unculled


@pytest.fixture(scope="module")
def setup():
    jx_scene, kw = jx_scenes.vocalfold(resolution=24, n_anim_frames=4)
    jb = JxBridge(jx_scene, **kw)
    tb, _, _ = main_path.build("cpu")
    # Jitted: one compile instead of one per eager op; both packages get these
    # same parameters.
    jp = {k: np.asarray(v) for k, v in jax.jit(jx_scene.compile())(jax.random.key(5), 0).items()}
    beams = np.array(jx_laser.generate_uniform_rays(0.0275, 12, 12))

    def jx_image(b):
        p = {k: jnp.asarray(v) for k, v in jp.items()}
        p.update(jx_laser.rays_to_beam_params(b, 30.0, sigma=10.0, texture_size=(256, 256)))
        scene_j = jb.assemble(p)
        o, d, _ = jx_rays.camera_rays_tiled(scene_j.camera, W, H, key=None)
        cfg_j = JxConfig(width=W, height=H, spp=1, max_bounces=1, static_geometry=True)
        return jx_pt.trace_rays(scene_j, o, d, jax.random.key(0), cfg_j,
                                primary_origin=scene_j.camera.to_world[:3, 3])

    img_j = np.asarray(jax.jit(jx_image)(jnp.asarray(beams)))

    def tc_image(b, tile_cull):
        params = from_jax_params(jp, "cpu")
        params.update(tc_laser.rays_to_beam_params(b, 30.0, sigma=10.0, texture_size=(256, 256)))
        scene = tb.assemble([params])
        o, d, _ = tc_rays.camera_rays_tiled(scene.camera, W, H)
        cfg = TcConfig(width=W, height=H, spp=1, max_bounces=1, static_geometry=True,
                       tile_cull=tile_cull)
        return tc_pt.trace_rays(scene, o, d, None, cfg,
                                primary_origin=scene.camera.to_world[:, :3, 3])[0]

    return img_j, tc_image, beams


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_unculled_render_and_gradient_match(setup, monkeypatch, route):
    if route == "streamed":
        monkeypatch.setattr(tc_intersect, "RESIDENT_MAX_FACES", 0)
    img_j, tc_image, beams = setup
    grads = {}
    for tile_cull in (False, True):
        b_t = torch.as_tensor(beams).requires_grad_(True)
        img_t = tc_image(b_t, tile_cull)
        img_t.mean().backward()
        grads[tile_cull] = b_t.grad.numpy()
        if not tile_cull:
            img_t = img_t.detach().numpy()
            assert img_t.shape == img_j.shape == (W * H, 3)
            assert np.isfinite(img_t).all() and img_t.max() > 0
            bad = np.abs(img_t - img_j).max(axis=1) > 1e-4 * np.abs(img_j).max()
            assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} pixels differ"
    assert np.isfinite(grads[False]).all() and np.abs(grads[False]).max() > 0
    rel = np.linalg.norm(grads[False] - grads[True]) / np.linalg.norm(grads[True])
    assert rel <= 1e-5, rel
