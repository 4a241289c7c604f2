"""Port parity for the differentiable face-table attribute route as a whole
(`RenderConfig(static_geometry=False)`, RenderConfig's default), on the
vocalfold scene (1440 faces) rendered by both packages from the same
randomized parameters, on a 128x16 film (one 2048-ray
tile), pixel-centre rays and one bounce (deterministic: the scene has only
delta emitters and no apertures):

  * flat shading: the image within 1e-4 of the image max on >= 99.9% of
    pixels (tests/test_torch_render.py's bar), and the gradient of the mean
    image with respect to a (3,) translation of every vertex within 1e-3
    relative L2 of JAX's;
  * smooth shading (`vocalfold(smooth=True)`: interpolated vertex normals,
    which turn the kernel-attribute route off even with static geometry):
    the image at the same bar;
  * `bench.measure(grad_mode="pose_soft", device="cpu")` at a tiny size
    prints a well-formed line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import bench, main_path
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import rays as tc_rays

torch.set_num_threads(2)

W, H = 128, 16


def _render(smooth: bool, static_geometry: bool = False, grad: bool = True):
    """(image, d mean image / d translation) of the deterministic one-bounce
    render from each package: ((jax), (torch)); one JAX compile.  The
    variant is the port's randomize (seed 5), its params handed to both
    bridges; JAX's derivative is forward mode (`jax.jacfwd` over the 3
    components: the derivative jax.grad gives, at a cheaper compile)."""
    tb, randomize, beams = main_path.build("cpu", smooth=smooth)
    params = randomize(main_path.generators([5], "cpu")[0], 0)
    params.update(tc_laser.rays_to_beam_params(beams, 30.0, sigma=10.0, texture_size=(256, 256)))
    jx_scene, kw = jx_scenes.vocalfold(resolution=24, n_anim_frames=4, smooth=smooth)
    jb = JxBridge(jx_scene, **kw)
    cfg = dict(width=W, height=H, spp=1, max_bounces=1, static_geometry=static_geometry)

    def jx_image(p, delta):
        scene = jb.assemble(p)
        geo = scene.geometry
        scene = scene.replace(geometry=geo.replace(vertices=geo.vertices + delta))
        o, d, _ = jx_rays.camera_rays_tiled(scene.camera, W, H, key=None)
        return jx_pt.trace_rays(scene, o, d, jax.random.key(0), JxConfig(**cfg),
                                primary_origin=scene.camera.to_world[:3, 3])

    def image_and_grad(p, delta):
        g = jax.jacfwd(lambda x: jnp.mean(jx_image(p, x)))(delta) if grad else jnp.zeros(3)
        return jx_image(p, delta), g

    p_np = {k: v if isinstance(v, tuple) else v.numpy() for k, v in params.items()}
    img_j, g_j = jax.jit(lambda x: image_and_grad(p_np, x))(jnp.zeros(3))

    scene = tb.assemble([params])
    assert (scene.geometry.normals is not None) == smooth
    delta = torch.zeros(3, requires_grad=grad)
    geo = scene.geometry
    scene = scene.replace(geometry=geo.replace(vertices=geo.vertices + delta))
    o, d, _ = tc_rays.camera_rays_tiled(scene.camera, W, H)
    with torch.set_grad_enabled(grad):
        img_t = tc_pt.trace_rays(scene, o, d, None, TcConfig(**cfg),
                                 primary_origin=scene.camera.to_world[:, :3, 3])[0]
    if grad:
        img_t.mean().backward()
    g_t = delta.grad.numpy() if grad else np.zeros(3)
    return (np.asarray(img_j), np.asarray(g_j)), (img_t.detach().numpy(), g_t)


@pytest.fixture(scope="module")
def flat():
    return _render(smooth=False)


def _image_matches(img_j, img_t):
    assert img_t.shape == img_j.shape == (W * H, 3)
    assert np.isfinite(img_t).all() and img_t.max() > 0
    bad = np.abs(img_t - img_j).max(axis=1) > 1e-4 * np.abs(img_j).max()
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} pixels differ"


def test_face_table_render_matches(flat):
    (img_j, _), (img_t, _) = flat
    _image_matches(img_j, img_t)


def test_translation_gradient_matches(flat):
    (_, g_j), (_, g_t) = flat
    assert np.abs(g_j).max() > 0 and np.isfinite(g_t).all()
    rel = np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    assert rel <= 1e-3, rel


def test_smooth_normal_render_matches():
    # static_geometry=True: smooth normals alone turn the kernel route off.
    (img_j, _), (img_t, _) = _render(smooth=True, static_geometry=True, grad=False)
    _image_matches(img_j, img_t)


def test_bench_measure_pose_soft_cpu_line():
    line = bench.measure(size=128, bounces=1, repeats=1, resolution=8, batch=1, trials=1,
                         grad_mode="pose_soft", soft_size=32, device="cpu")
    assert set(line) == {"metric", "value", "unit", "detail"}
    assert line["metric"].startswith("128x128 diff-renders/sec/chip (vocalfold ")
    assert "pose-grad soft mask32" in line["metric"] and "diff-attrs" in line["metric"]
    assert line["unit"] == "renders/sec/chip" and np.isfinite(line["value"]) and line["value"] > 0
    detail = line["detail"]
    assert detail["grad_mode"] == "pose_soft" and detail["static_geometry"] is False
    assert detail["device"] == "cpu" and detail["peak_device_memory_gib"] is None
    assert np.isfinite(detail["loss"]) and detail["loss"] > 0
