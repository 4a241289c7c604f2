"""Port parity for the reference-shape render path: the streamed kernels'
route (B2 for camera and shadow rays, B4 for bounce rays, with
kernel-emitted hit attributes), the mid-sized route (B5 for bounce rays),
`coherent_bounce` and `shared_primary`, on the vocalfold scene (1440
faces) and a 128x32 film (two 2048-ray tiles).  The dispatcher's face-count
thresholds are lowered to 0 so that these routes' plain versions run at
this size.

  * the coherent bounce draw is held in tests/test_torch_coherent_draw.py;
  * streamed route, deterministic one-bounce render (pixel-centre rays)
    within 1e-4 of the image max on >= 99.9% of pixels, and the beam
    gradient within 1e-3 relative L2, as tests/test_torch_render.py holds
    the resident route;
  * spp 2, shared primary + coherent bounce, two bounces: the mean
    radiances over 4 seeds agree with the JAX renderer's within
    4 sqrt(SEM_port^2 + SEM_jax^2), on the streamed and on the B5 route;
  * shared primary with max_bounces=1 equals the unshared render.
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
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import rays as tc_rays

torch.set_num_threads(2)

W, H = 128, 32
SEEDS = 4


def _cfg(lib, bounces, spp=1, shared=False):
    cls = JxConfig if lib == "jax" else TcConfig
    return cls(width=W, height=H, spp=spp, max_bounces=bounces, static_geometry=True,
               coherent_bounce=shared, shared_primary=shared)


def _route(monkeypatch, route):
    name = {"streamed": "RESIDENT_MAX_FACES", "general_culled": "GEN_CULL_MIN_FACES"}[route]
    monkeypatch.setattr(tc_intersect, name, 0)


@pytest.fixture(scope="module")
def setup():
    jx_scene, kw = jx_scenes.vocalfold(resolution=24, n_anim_frames=4)
    jb = JxBridge(jx_scene, **kw)
    tb, _, _ = main_path.build("cpu")
    # Jitted: one compile instead of one per eager op; both packages get these
    # same parameters.
    jp = {k: np.asarray(v) for k, v in jax.jit(jx_scene.compile())(jax.random.key(5), 0).items()}
    beams = np.array(jx_laser.generate_uniform_rays(0.0275, 12, 12))

    def jx_assemble(b):
        p = {k: jnp.asarray(v) for k, v in jp.items()}
        p.update(jx_laser.rays_to_beam_params(b, 30.0, sigma=10.0, texture_size=(256, 256)))
        return jb.assemble(p)

    def tc_assemble(b, copies=1):
        p = from_jax_params(jp, "cpu")
        p.update(tc_laser.rays_to_beam_params(b, 30.0, sigma=10.0, texture_size=(256, 256)))
        return tb.assemble([p] * copies)

    return jx_assemble, tc_assemble, beams


@pytest.fixture(scope="module")
def jax_means(setup):
    """Mean radiance of the JAX renderer's spp-2 shared + coherent render,
    one per seed."""
    jx_assemble, _, beams = setup
    scene_j = jx_assemble(jnp.asarray(beams))
    cfg_j = _cfg("jax", 2, spp=2, shared=True)
    return np.asarray(jax.jit(jax.vmap(
        lambda k: jnp.mean(jx_pt.render_rgb(scene_j, k, cfg_j))))(
            jax.random.split(jax.random.key(1), SEEDS)))


def _jx_image(jx_assemble, beams):
    scene = jx_assemble(beams)
    o, d, _ = jx_rays.camera_rays_tiled(scene.camera, W, H, key=None)
    return jx_pt.trace_rays(scene, o, d, jax.random.key(0), _cfg("jax", 1),
                            primary_origin=scene.camera.to_world[:3, 3])


def _tc_image(tc_assemble, beams):
    scene = tc_assemble(beams)
    o, d, _ = tc_rays.camera_rays_tiled(scene.camera, W, H)
    return tc_pt.trace_rays(scene, o, d, None, _cfg("torch", 1),
                            primary_origin=scene.camera.to_world[:, :3, 3])[0]


def test_streamed_route_render_and_gradient_match(setup, monkeypatch):
    _route(monkeypatch, "streamed")
    jx_assemble, tc_assemble, beams = setup
    img_j = np.asarray(jax.jit(lambda b: _jx_image(jx_assemble, b))(jnp.asarray(beams)))
    b_t = torch.as_tensor(beams).requires_grad_(True)
    img_t = _tc_image(tc_assemble, b_t)
    img_t.mean().backward()
    img_t = img_t.detach().numpy()
    assert np.isfinite(img_t).all() and img_t.max() > 0
    bad = np.abs(img_t - img_j).max(axis=1) > 1e-4 * np.abs(img_j).max()
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} pixels differ"

    g_j = np.asarray(jax.jit(jax.grad(
        lambda b: jnp.mean(_jx_image(jx_assemble, b))))(jnp.asarray(beams)))
    g_t = b_t.grad.numpy()
    assert np.abs(g_j).max() > 0
    rel = np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    assert rel <= 1e-3, rel


@pytest.mark.parametrize("route", ["streamed", "general_culled"])
def test_shared_coherent_mean_radiance_agrees(setup, jax_means, monkeypatch, route):
    _route(monkeypatch, route)
    _, tc_assemble, beams = setup
    with torch.no_grad():
        scene_t = tc_assemble(torch.as_tensor(beams), copies=SEEDS)
        img = tc_pt.render_rgb(scene_t, main_path.generators(range(SEEDS), "cpu"),
                               _cfg("torch", 2, spp=2, shared=True))
    means_t = img.mean(dim=(1, 2, 3)).numpy()
    assert np.isfinite(means_t).all() and means_t.min() > 0
    sem = np.sqrt(means_t.var(ddof=1) / SEEDS + jax_means.var(ddof=1) / SEEDS)
    assert abs(means_t.mean() - jax_means.mean()) <= 4 * sem, (
        means_t.mean(), jax_means.mean(), sem)


def test_shared_primary_one_bounce_equals_unshared(setup, monkeypatch):
    _route(monkeypatch, "streamed")
    _, tc_assemble, beams = setup
    with torch.no_grad():
        scene_t = tc_assemble(torch.as_tensor(beams), copies=2)
        imgs = [tc_pt.render_rgb(scene_t, main_path.generators([7, 8], "cpu"),
                                 _cfg("torch", 1, shared=shared)) for shared in (False, True)]
    assert imgs[0].shape == (2, H, W, 3) and imgs[0].max() > 0
    assert torch.equal(imgs[0], imgs[1])
