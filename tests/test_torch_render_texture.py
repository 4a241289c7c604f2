"""Port parity for the projector texture route as a whole and for the
batched pattern step, on the vocalfold scene (1440 faces) and a 128x32 film
(two 2048-ray tiles):

  * the texture route (`rays_to_texture_rgb` of the beams, 256x256 and no
    blur, as `bench.py`'s `analytic=0` rows build it, in "tex.data"):
    deterministic one-bounce render (pixel-centre rays) within 1e-4 of the
    image max on >= 99.9% of pixels, and the beam gradient of the mean image
    (through rasterize, then the projector's bilinear gather) within 1e-3
    relative L2, the bars tests/test_torch_render.py holds the analytic
    projector to;
  * `main_path.pattern_step`, one batched render and one backward, against
    the per-variant loop it replaced (render one variant, backward,
    accumulate): each variant draws from its own generator, so loss and
    gradient agree up to summation order, within 1e-5 relative (2 variants,
    2 bounces, the vocalfold scene at resolution 8, 416 faces);
  * `bench.measure` on the CPU at a tiny size prints a well-formed line, and
    every row of its VARIANTS runs (none is refused).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import H, W, _cfg

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import bench, main_path
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import rays as tc_rays

torch.set_num_threads(2)


def _texture(laser, beams):
    return laser.rays_to_texture_rgb(beams, 30.0, sigma=10.0, texture_size=(256, 256),
                                     blur_kernel=0)


@pytest.fixture(scope="module")
def texture_route():
    """(image, beam gradient of the mean image) of the deterministic
    one-bounce texture-route render, from each package: ((jax), (torch))."""
    jx_scene, kw = jx_scenes.vocalfold(resolution=24, n_anim_frames=4)
    jb = JxBridge(jx_scene, **kw)
    jp = {k: np.asarray(v) for k, v in jax.jit(jx_scene.compile())(jax.random.key(5), 0).items()}
    beams = np.array(jx_laser.generate_uniform_rays(0.0275, 12, 12))

    def jx_image(b):
        scene = jb.assemble(dict({k: jnp.asarray(v) for k, v in jp.items()},
                                 **{"tex.data": _texture(jx_laser, b)}))
        o, d, _ = jx_rays.camera_rays_tiled(scene.camera, W, H, key=None)
        return jx_pt.trace_rays(scene, o, d, jax.random.key(0), _cfg("jax", 1),
                                primary_origin=scene.camera.to_world[:3, 3])

    def image_and_grad(b):  # one compile for both
        img, vjp = jax.vjp(jx_image, b)
        return img, vjp(jnp.full_like(img, 1.0 / img.size))[0]

    img_j, g_j = jax.jit(image_and_grad)(jnp.asarray(beams))
    tb, _, _ = main_path.build("cpu")
    b_t = torch.as_tensor(beams).requires_grad_(True)
    scene = tb.assemble(dict(from_jax_params(jp, "cpu"), **{"tex.data": _texture(tc_laser, b_t)}))
    assert scene.projector.beams_ndc is None and scene.projector.texture.shape == (256, 256, 3)
    o, d, _ = tc_rays.camera_rays_tiled(scene.camera, W, H)
    img_t = tc_pt.trace_rays(scene, o, d, None, _cfg("torch", 1),
                             primary_origin=scene.camera.to_world[:, :3, 3])[0]
    img_t.mean().backward()
    return (np.asarray(img_j), np.asarray(g_j)), (img_t.detach().numpy(), b_t.grad.numpy())


def test_texture_route_render_matches(texture_route):
    (img_j, _), (img_t, _) = texture_route
    assert img_t.shape == img_j.shape == (W * H, 3)
    assert np.isfinite(img_t).all() and img_t.max() > 0
    bad = np.abs(img_t - img_j).max(axis=1) > 1e-4 * np.abs(img_j).max()
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} pixels differ"


def test_texture_route_beam_gradient_matches(texture_route):
    (_, g_j), (_, g_t) = texture_route
    assert np.abs(g_j).max() > 0 and np.isfinite(g_t).all()
    rel = np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    assert rel <= 1e-3, rel


def test_pattern_step_batched_matches_loop():
    bridge, randomize, beams = main_path.build("cpu", resolution=8)
    cfg, seeds = _cfg("torch", 2), [3, 4]
    loss, grad = main_path.pattern_step(bridge, randomize, beams, seeds, cfg)
    leaf = beams.detach().requires_grad_(True)
    loss_loop = 0.0
    for seed in seeds:
        loss_i = main_path.render_batch(bridge, randomize, leaf, [seed], cfg).mean() / len(seeds)
        loss_i.backward()
        loss_loop += float(loss_i.detach())
    assert grad.shape == (144, 3) and grad.abs().max() > 0
    torch.testing.assert_close(float(loss), loss_loop, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(grad, leaf.grad, rtol=1e-5, atol=1e-5 * float(leaf.grad.abs().max()))


def test_bench_measure_cpu_line():
    line = bench.measure(size=128, bounces=1, repeats=1, resolution=8, batch=1, trials=1,
                         analytic=0, device="cpu")
    assert set(line) == {"metric", "value", "unit", "detail"}
    assert line["metric"].startswith("128x128 diff-renders/sec/chip (vocalfold ")
    assert "static-geometry" in line["metric"] and "analytic-projector" not in line["metric"]
    assert line["unit"] == "renders/sec/chip" and np.isfinite(line["value"]) and line["value"] > 0
    detail = line["detail"]
    assert detail["route"] == "texture" and detail["device"] == "cpu"
    assert detail["peak_device_memory_gib"] is None and detail["card"] is None
    assert (detail["batch"], detail["repeats"], detail["size"], detail["spp"]) == (1, 1, 128, 1)
    spread = detail["renders_per_sec_dispersion"]
    assert spread["trials"] == 1 and spread["min"] == spread["max"] == line["value"]
    # Every row runs: none is refused any more, and each row's keys are
    # measure's arguments (or the datagen row's flag alone).
    assert len(bench.VARIANTS) == 22 and not hasattr(bench, "refusal")
    args = set(inspect.signature(bench.measure).parameters) - {"device"}
    for row in bench.VARIANTS:
        assert row == {"datagen": 1} or set(row) <= args, row
        assert row.get("grad_mode", "beams") in ("beams", "pose_soft", "pose_reparam"), row
    reparam_rows = [row for row in bench.VARIANTS if row.get("grad_mode") == "pose_reparam"]
    assert [(r["size"], r["reparam_chunk"], r["batch"]) for r in reparam_rows] == [
        (256, 1024, 2), (512, 8192, 2)]
