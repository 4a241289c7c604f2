"""Port parity for the helpers of `estimation/laser_estimation.py` and for
SMARTY's mean-depth rule, on the same inputs as the JAX package:

  * `probability_distribution_from_depth_maps` (the population standard
    deviation) within 1e-6, and `points_from_probability_distribution` fed
    the reference's Gumbel draws: the same index set (`torch.topk` and
    `lax.top_k` may order ties differently);
  * `generate_epipolar_constraints`: the same mask, on a camera that sees
    part of the projector's frustum and on a degenerate one (all ones);
    `laser_from_ndc_points` within 1e-5;
  * SMARTY on depth maps with misses (depth 0), given to both packages:
    the reference's mean depth is NaN there and becomes 1.0 (not the mean
    over the hits), the beams agree within 1e-5, and the debug images of
    `save_images` are the same PNG bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.estimation import laser_estimation as jx_le
from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import integrators as jx_int
from fireflies_tpu.render.types import Camera as JxCamera
from fireflies_tpu.utils import math as jx_math
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.estimation import laser_estimation as tc_le
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import SceneBridge as TcBridge
from fireflies_tpu_torch.render import integrators as tc_int
from fireflies_tpu_torch.render.types import Camera as TcCamera

torch.set_num_threads(1)

W, H = 128, 32


def _cameras(to_world, fov):
    to_world = np.asarray(to_world, np.float32)
    jcam = JxCamera.create(to_world, fov=fov)
    one = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    tcam = TcCamera(to_world=torch.from_numpy(to_world)[None], fov=one(fov), near=one(0.01),
                    far=one(1000.0))
    return jcam, tcam


def test_probability_map_and_gumbel_top_k_match():
    rng = np.random.default_rng(3)
    maps = rng.uniform(0.5, 2.0, (5, H, W)).astype(np.float32)
    maps[:, :4] = 1.25  # rows without variance: only the uniform floor
    prob = tc_le.probability_distribution_from_depth_maps(torch.from_numpy(maps), 1e-3)
    prob_ref = jx_le.probability_distribution_from_depth_maps(jnp.asarray(maps), 1e-3)
    np.testing.assert_allclose(prob.numpy(), np.asarray(prob_ref), rtol=1e-6, atol=1e-7)
    assert float(prob[:4].max()) == np.float32(1e-3)

    key = jax.random.key(5)
    idx_ref = np.asarray(jx_le.points_from_probability_distribution(prob_ref, 60, key))
    gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(key, (H * W,))))
    idx = tc_le.points_from_probability_distribution(prob, 60, gumbel=gumbel)
    assert idx.shape == (60,) and set(idx.tolist()) == set(idx_ref.tolist())
    drawn = tc_le.points_from_probability_distribution(prob, 60, torch.Generator().manual_seed(0))
    assert len(set(drawn.tolist())) == 60 and int(drawn.max()) < H * W


def test_epipolar_constraints_and_beams_from_pixels_match():
    proj_world = jx_math.look_at_np([0.6, 0.1, 2.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    for cam_world, fov, partial in (
            (jx_math.look_at_np([0.0, 0.0, 2.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]), 90.0, True),
            # Looking away: every far corner behind the camera.
            (jx_math.look_at_np([0.0, 0.0, 2.5], [0.0, 0.0, 5.0], [0.0, 1.0, 0.0]), 40.0, False)):
        jcam, tcam = _cameras(cam_world, fov)
        mask_ref = jx_le.generate_epipolar_constraints(jcam, jnp.asarray(proj_world), 30.0,
                                                       1000.0, (H, W))
        mask = tc_le.generate_epipolar_constraints(tcam, torch.from_numpy(proj_world), 30.0,
                                                   1000.0, (H, W))
        assert mask.dtype == np.float32 and mask.shape == (H, W)
        np.testing.assert_array_equal(mask, mask_ref)
        if partial:
            assert 0.05 < mask.mean() < 0.95

    jcam, tcam = _cameras(jx_math.look_at_np([0.1, 0.2, 2.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
                          50.0)
    chosen = np.random.default_rng(7).choice(H * W, 40, replace=False)
    origin = np.asarray([0.6, 0.1, 2.0], np.float32)
    got = tc_le.laser_from_ndc_points(tcam, torch.from_numpy(origin), torch.tensor(1.7),
                                      torch.from_numpy(chosen), (H, W))
    ref = jx_le.laser_from_ndc_points(jcam, jnp.asarray(origin), jnp.float32(1.7),
                                      jnp.asarray(chosen, jnp.int32), (H, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_smarty_mean_depth_with_misses_matches(monkeypatch, tmp_path):
    jscene, kw = jx_scenes.vocalfold(resolution=8, n_anim_frames=2)
    tscene, tkw = tc_scenes.vocalfold(resolution=8, n_anim_frames=2)
    jbridge, tbridge = JxBridge(jscene, **kw), TcBridge(tscene, **tkw)
    rng = np.random.default_rng(9)
    maps = rng.uniform(1.5, 2.2, (3, H, W)).astype(np.float32)
    maps[:, :, :10] = 0.0  # the film's left edge misses in every map
    maps[1, 20:, 60:70] = 0.0
    monkeypatch.setattr(jx_int, "random_depth_maps", lambda *a, **k: jnp.asarray(maps))
    monkeypatch.setattr(tc_int, "render_depth", lambda *a, **k: torch.from_numpy(maps))

    cfg = dict(n_beams=40, n_depthmaps=3, image_size=(W, H), smarty_min_radius=2.0,
               smarty_max_radius=8.0, save_images=True)
    rcfg = dict(width=W, height=H, spp=1, max_bounces=1)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = jx_le.initialize_laser(jscene, jbridge, jx_le.LaserConfig(**cfg, save_dir=str(
        tmp_path / "jax")), mode="SMARTY", render_config=JxConfig(**rcfg))
    # The reference variant (key(0) at step 0) carried over; the depth-map
    # variants are not rendered (render_depth is replaced above).
    params = {k: np.asarray(v) for k, v in jscene.compile()(jax.random.key(0), 0).items()}
    ref_scene = tbridge.assemble([from_jax_params(params, "cpu")])
    info = {}
    got = tc_le.initialize_laser(tscene, tbridge, tc_le.LaserConfig(**cfg, save_dir=str(
        tmp_path / "port")), mode="SMARTY", device="cpu", render_config=TcConfig(**rcfg),
        variants=(None, ref_scene), info=info)
    assert float(info["mean_depth"]) == 1.0  # NaN over the misses, then 1.0
    assert abs(float(maps[maps > 0].mean()) - 1.0) > 0.5
    rays, rays_ref = got.local_rays(), np.asarray(ref.local_rays())
    assert rays.shape == rays_ref.shape and rays.shape[0] > 10
    np.testing.assert_allclose(rays.numpy(), rays_ref, rtol=1e-5, atol=1e-5)
    for name in ("sampling_map.png", "constraint_map.png"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_smarty_draws_its_variants_in_one_batch(monkeypatch):
    """Without given variants SMARTY randomizes n_depthmaps variants at
    steps 0 .. n-1 and renders them in one `random_depth_maps` batch."""
    tscene, tkw = tc_scenes.vocalfold(resolution=8, n_anim_frames=2)
    calls = []
    draw = tc_int.random_depth_maps

    def recorded(randomize_fn, gens, config):
        calls.append((len(gens), config.width, config.height))
        return draw(lambda g, s: calls.append(list(s)) or randomize_fn(g, s), gens, config)

    monkeypatch.setattr(tc_int, "random_depth_maps", recorded)
    cfg = tc_le.LaserConfig(n_beams=40, n_depthmaps=3, image_size=(W, H), smarty_min_radius=2.0,
                            smarty_max_radius=8.0)
    info = {}
    laser = tc_le.initialize_laser(tscene, TcBridge(tscene, **tkw), cfg, mode="SMARTY",
                                   device="cpu", info=info)
    assert calls == [(3, W, H), [0, 1, 2]]
    assert info["depth_maps"].shape == (3, H, W) and bool((info["depth_maps"] > 0).all())
    rays = laser.local_rays()
    assert rays.shape[0] > 10 and bool(torch.isfinite(rays).all())
    assert float((rays.norm(dim=-1) - 1).abs().max()) < 1e-5 and float(rays[:, 2].max()) < 0
    assert info["bridson_s"] > 0 and info["total_s"] >= info["depth_maps_s"] + info["bridson_s"]
