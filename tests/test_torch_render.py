"""Port parity for the slice as a whole: the vocalfold scene (1440 faces)
rendered by both packages from the same randomized parameters
(`from_jax_params`), on a 128x32 film (two 2048-ray tiles).

  * deterministic render (pixel-centre rays, one bounce — vocalfold has only
    delta emitters and no apertures, so nothing is random): within 1e-4 of
    the image max on >= 99.9% of pixels, and every exception is a pixel
    whose primary hit differs by a tie;
  * beam gradient of the mean image: relative L2 error <= 1e-3;
  * two bounces: the mean radiances over 8 seeds each agree within
    4 sqrt(SEM_port^2 + SEM_jax^2).
`pattern_step` and the second asset are in tests/test_torch_render_step.py.
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
from fireflies_tpu.render import intersect as jx_intersect
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import rays as tc_rays

torch.set_num_threads(1)

W, H = 128, 32
SEEDS = 8


def _cfg(lib, bounces):
    cls = JxConfig if lib == "jax" else TcConfig
    return cls(width=W, height=H, spp=1, max_bounces=bounces, static_geometry=True)


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


def _jx_image(jx_assemble, beams, bounces=1):
    scene = jx_assemble(beams)
    o, d, _ = jx_rays.camera_rays_tiled(scene.camera, W, H, key=None)
    return jx_pt.trace_rays(scene, o, d, jax.random.key(0), _cfg("jax", bounces),
                            primary_origin=scene.camera.to_world[:3, 3])


def _tc_image(tc_assemble, beams, bounces=1):
    scene = tc_assemble(beams)
    o, d, _ = tc_rays.camera_rays_tiled(scene.camera, W, H)
    return tc_pt.trace_rays(scene, o, d, None, _cfg("torch", bounces),
                            primary_origin=scene.camera.to_world[:, :3, 3])[0]


@pytest.fixture(scope="module")
def one_bounce(setup):
    """The deterministic one-bounce render and the beam gradient of its mean
    image, from each package: (img_j, g_j, img_t, g_t); one JAX compile and
    one port backward for both."""
    jx_assemble, tc_assemble, beams = setup

    def image_and_grad(b):
        img, vjp = jax.vjp(lambda x: _jx_image(jx_assemble, x), b)
        return img, vjp(jnp.full_like(img, 1.0 / img.size))[0]

    img_j, g_j = jax.jit(image_and_grad)(jnp.asarray(beams))
    b_t = torch.as_tensor(beams).requires_grad_(True)
    img_t = _tc_image(tc_assemble, b_t)
    img_t.mean().backward()
    return np.asarray(img_j), np.asarray(g_j), img_t.detach().numpy(), b_t.grad.numpy()


def test_deterministic_render_matches(setup, one_bounce):
    jx_assemble, tc_assemble, beams = setup
    img_j, _, img_t, _ = one_bounce
    assert img_t.shape == img_j.shape == (W * H, 3)
    assert np.isfinite(img_t).all() and img_t.max() > 0
    bad = np.abs(img_t - img_j).max(axis=1) > 1e-4 * np.abs(img_j).max()
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} pixels differ"
    if bad.any():  # each exception must be a tie on the primary hit
        jscene = jx_assemble(jnp.asarray(beams))
        tscene = tc_assemble(torch.as_tensor(beams))
        o, d, _ = jx_rays.camera_rays_tiled(jscene.camera, W, H, key=None)
        ref = jx_intersect.intersect_brute(o, d, jscene.geometry)
        ot, dt, _ = tc_rays.camera_rays_tiled(tscene.camera, W, H)
        ours = tc_intersect.closest_hit(ot, dt, tscene.geometry,
                                        shared_origin=tscene.camera.to_world[:, :3, 3])
        p_j, t_j = np.asarray(ref.prim)[bad], np.asarray(ref.t)[bad]
        p_t, t_t = ours.prim[0].numpy()[bad], ours.t[0].numpy()[bad]
        assert np.all(p_j != p_t)
        np.testing.assert_allclose(t_t, t_j, rtol=1e-5)


def test_beam_gradient_matches(one_bounce):
    _, g_j, _, g_t = one_bounce
    assert np.abs(g_j).max() > 0
    rel = np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    assert rel <= 1e-3, rel


def test_two_bounce_mean_radiance_agrees(setup):
    jx_assemble, tc_assemble, beams = setup
    cfg_j = _cfg("jax", 2)
    scene_j = jx_assemble(jnp.asarray(beams))
    means_j = np.asarray(jax.jit(jax.vmap(
        lambda k: jnp.mean(jx_pt.render_rgb(scene_j, k, cfg_j))))(
            jax.random.split(jax.random.key(1), SEEDS)))
    with torch.no_grad():
        scene_t = tc_assemble(torch.as_tensor(beams), copies=SEEDS)
        img = tc_pt.render_rgb(scene_t, main_path.generators(range(SEEDS), "cpu"),
                               _cfg("torch", 2))
    means_t = img.mean(dim=(1, 2, 3)).numpy()
    assert np.isfinite(means_t).all()
    sem = np.sqrt(means_t.var(ddof=1) / SEEDS + means_j.var(ddof=1) / SEEDS)
    assert abs(means_t.mean() - means_j.mean()) <= 4 * sem, (means_t.mean(), means_j.mean(), sem)
