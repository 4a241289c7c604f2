"""Port parity for what the optimizers stand on: the laser and camera
helpers, the respawns, the checkpoints and the batched variant loss.

  * `rays_to_world`, `origin_per_ray`, `clamp_rays_to_fov`,
    `ndc_to_directions`, `camera.points_to_ndc` and `rays.ndc_to_pixel`
    within 1e-6 of the reference on the same inputs;
  * `respawn_out_of_bounds` / `respawn_out_of_camera`: rows in bounds equal
    the reference's (1e-6), replaced rows are fresh unit beams inside the
    NDC square;
  * a checkpoint written by the JAX package loads in the port, and one the
    port writes loads in the JAX package, leaf for leaf;
  * `main_path.variant_loss` is one batched render reduced per variant:
    each variant's loss equals the loss of that variant rendered alone.
"""

import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu.optim import checkpoint as jx_ckpt
from fireflies_tpu.projection import camera as jx_camera
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch import optim as tc_optim
from fireflies_tpu_torch.optim import checkpoint as tc_ckpt
from fireflies_tpu_torch.projection import camera as tc_camera
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import rays as tc_rays
from fireflies_tpu_torch.utils import math as ffmath

torch.set_num_threads(2)

FOV = 30.0


def _beams(n=40, spread=0.4, seed=0):
    """Unit beams looking down -Z, some outside a 30 degree frustum."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.uniform(-spread, spread, (n, 2)), -np.ones((n, 1))], -1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _pose(seed=1):
    rng = np.random.default_rng(seed)
    m = ffmath.look_at_np(rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3))
    return np.asarray(m, np.float32)


def test_laser_and_camera_helpers_match():
    beams, pose = _beams(), _pose()
    tb, tp = torch.from_numpy(beams), torch.from_numpy(pose)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tc_laser.rays_to_world(tb, tp).numpy(),
                               np.asarray(jx_laser.rays_to_world(beams, pose)), **close)
    np.testing.assert_allclose(tc_laser.origin_per_ray(tp, 40).numpy(),
                               np.asarray(jx_laser.origin_per_ray(pose, 40)), **close)
    clamped = tc_laser.clamp_rays_to_fov(tb, FOV, 0.9)
    np.testing.assert_allclose(clamped.numpy(),
                               np.asarray(jx_laser.clamp_rays_to_fov(beams, FOV, 0.9)), **close)
    assert tc_camera.directions_to_ndc(clamped, FOV).abs().max() <= 0.9 + 1e-6
    ndc = np.random.default_rng(2).uniform(-1, 1, (40, 2)).astype(np.float32)
    np.testing.assert_allclose(tc_camera.ndc_to_directions(torch.from_numpy(ndc), FOV).numpy(),
                               np.asarray(jx_camera.ndc_to_directions(ndc, FOV)), **close)
    pts = np.random.default_rng(3).uniform(-1, 1, (40, 3)).astype(np.float32)
    got = tc_camera.points_to_ndc(torch.from_numpy(pts), tp, FOV).numpy()
    np.testing.assert_allclose(got, np.asarray(jx_camera.points_to_ndc(pts, pose, FOV)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc_rays.ndc_to_pixel(torch.from_numpy(got), 128, 32).numpy(),
                               np.asarray(jx_rays.ndc_to_pixel(got, 128, 32)), **close)


def test_respawns_keep_in_bounds_rows_and_replace_the_rest():
    beams = _beams(spread=0.5)
    tb = torch.from_numpy(beams)
    inside = (np.abs(np.asarray(jx_camera.directions_to_ndc(beams, FOV))) < 1.0).all(-1)
    assert 0 < inside.sum() < len(beams)
    cam_ndc = np.random.default_rng(4).uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
    on_cam = (np.abs(cam_ndc[:, :2]) < 1.0).all(-1)
    assert 0 < on_cam.sum() < len(beams)
    gen = torch.Generator().manual_seed(0)
    cases = [
        (tc_laser.respawn_out_of_bounds(gen, tb, FOV),
         np.asarray(jx_laser.respawn_out_of_bounds(jnp.zeros((2,), jnp.uint32), beams, FOV)),
         inside),
        (tc_laser.respawn_out_of_camera(gen, tb, torch.from_numpy(cam_ndc), FOV),
         np.asarray(jx_laser.respawn_out_of_camera(jnp.zeros((2,), jnp.uint32), beams, cam_ndc,
                                                   FOV)),
         on_cam),
    ]
    for got, ref, kept in cases:
        got = got.numpy()
        np.testing.assert_allclose(got[kept], ref[kept], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
        fresh = tc_camera.directions_to_ndc(torch.from_numpy(got[~kept]), FOV).numpy()
        assert (np.abs(fresh) < 1.0).all() and not np.allclose(got[~kept], beams[~kept])


def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    rays, m, v = (rng.standard_normal((6, 3)).astype(np.float32) for _ in range(3))
    jx_state = {"params": {"rays": jnp.asarray(rays), "z": jnp.float32(1.5)},
                "opt": (jnp.asarray(m), [jnp.asarray(v)]), "step": jnp.int32(7)}
    jx_ckpt.save_checkpoint(tmp_path / "a" / "00007.npz", jx_state)
    like = {"params": {"rays": torch.zeros(6, 3), "z": torch.zeros(())},
            "opt": (torch.zeros(6, 3), [torch.zeros(6, 3)]),
            "step": torch.zeros((), dtype=torch.int32)}
    got = tc_ckpt.load_checkpoint(tc_ckpt.latest_checkpoint(tmp_path / "a"), like)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    np.testing.assert_array_equal(got["params"]["rays"].numpy(), rays)
    np.testing.assert_array_equal(got["opt"][1][0].numpy(), v)
    assert float(got["params"]["z"]) == 1.5

    tc_ckpt.save_checkpoint(tmp_path / "b" / "00001.npz", got)
    tc_ckpt.save_checkpoint(tmp_path / "b" / "00002.npz", dict(got, step=torch.tensor(8)))
    path = tc_ckpt.latest_checkpoint(tmp_path / "b")
    assert path.name == "00002.npz" and tc_ckpt.latest_checkpoint(tmp_path / "none") is None
    back = jx_ckpt.load_checkpoint(path, jx_state)
    assert int(back["step"]) == 8
    np.testing.assert_array_equal(np.asarray(back["opt"][0]), m)
    np.testing.assert_array_equal(np.asarray(back["params"]["rays"]), rays)


def test_variant_loss_reduces_each_variant_alone():
    bridge, randomize, beams = main_path.build("cpu", resolution=8)
    cfg = main_path.bench_config(size=128, bounces=1).replace(height=16)
    loss_fn = main_path.variant_loss(bridge, randomize, cfg, tc_optim.dot_coverage_objective(1))
    with torch.no_grad():
        both = loss_fn(beams, main_path.generators([3, 4], "cpu"), 2)
        alone = [loss_fn(beams, main_path.generators([s], "cpu"), 2) for s in (3, 4)]
    assert both.shape == (2,) and bool(torch.isfinite(both).all()) and both[0] != both[1]
    np.testing.assert_allclose(both.numpy(), torch.cat(alone).numpy(), rtol=1e-6)
