"""Port parity for the optimizers (`optim/pattern.py`, `optim/inverse.py`):
the same inputs, made with numpy, through both packages.

  * `optimize_point_pattern` (12 points, 64x64, 20 steps, init points
    given): points and losses within 1e-5;
  * `overlap_loss` and `dot_coverage_objective` on fixed points and images
    within 1e-6 relative (the port's objective on a batch equals the
    reference's on each image);
  * `optimize_pattern_through_render` and `optimize_params` with one
    deterministic loss in both packages (it ignores the keys and draws),
    respawn off, 5 steps: rays, params and losses within 1e-5.  This holds
    torch.optim.Adam to optax.adam, the re-normalization and the averaging
    over the variants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu import optim as jx_optim
from fireflies_tpu_torch import optim as tc_optim

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def test_point_pattern_loop_matches():
    rng = np.random.default_rng(0)
    init = (0.5 + 0.05 * rng.standard_normal((12, 2))).astype(np.float32)
    kw = dict(n_points=12, sigma=40.0, texture_size=(64, 64), steps=20, learning_rate=5e-3,
              chunk=12)
    ref = jx_optim.optimize_point_pattern(jax.random.key(0), init_points=jnp.asarray(init), **kw)
    got = tc_optim.optimize_point_pattern(init_points=torch.from_numpy(init), **kw)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(ref.losses), **TOL)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), **TOL)
    assert float(got.losses[-1]) < float(got.losses[0])


def test_objectives_match():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.2, 0.8, (9, 2)).astype(np.float32)
    ref = float(jx_optim.overlap_loss(jnp.asarray(pts), 30.0, (48, 40), chunk=4))
    got = float(tc_optim.overlap_loss(torch.from_numpy(pts), 30.0, (48, 40), chunk=4))
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6)

    imgs = rng.uniform(0.0, 1.0, (3, 16, 24, 3)).astype(np.float32) ** 4
    jx_obj, tc_obj = jx_optim.dot_coverage_objective(1), tc_optim.dot_coverage_objective(1)
    ref = np.array([float(jx_obj(jnp.asarray(im), {})) for im in imgs])
    got = tc_obj(torch.from_numpy(imgs), {}).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _ray_target():
    rng = np.random.default_rng(2)
    return rng.standard_normal((6, 3)).astype(np.float32)


def test_pattern_through_render_loop_matches():
    target = _ray_target()
    rays0 = target + 0.3 * np.random.default_rng(3).standard_normal((6, 3)).astype(np.float32)
    rays0 /= np.linalg.norm(rays0, axis=-1, keepdims=True)
    weight = np.linspace(0.5, 2.0, 18, dtype=np.float32).reshape(6, 3)

    def jx_loss(rays, key, step):
        return jnp.sum(weight * (rays - target) ** 2) + 0.1 * step * jnp.sum(jnp.sin(3.0 * rays))

    def tc_loss(rays, gens, step):
        w, t = torch.from_numpy(weight), torch.from_numpy(target)
        one = (w * (rays - t) ** 2).sum() + 0.1 * step * torch.sin(3.0 * rays).sum()
        return one.expand(len(gens))

    kw = dict(steps=5, batch=3, learning_rate=2e-2, fov_deg=30.0, respawn_oob=False)
    ref = jx_optim.optimize_pattern_through_render(jx_loss, jnp.asarray(rays0),
                                                   jax.random.key(0), **kw)
    got = tc_optim.optimize_pattern_through_render(tc_loss, torch.from_numpy(rays0), seed=0, **kw)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(ref.losses), **TOL)
    np.testing.assert_allclose(got.rays.numpy(), np.asarray(ref.rays), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.rays.numpy(), axis=-1), 1.0, atol=1e-6)


def test_optimize_params_matches():
    rng = np.random.default_rng(4)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": np.float32(0.5)}
    target = rng.standard_normal((4, 3)).astype(np.float32)

    def jx_loss(tr, key):
        return jnp.sum((tr["a"] - target) ** 2 * tr["b"] ** 2) + (tr["b"] - 2.0) ** 2

    def tc_loss(tr, gens):
        t = torch.from_numpy(target)
        one = ((tr["a"] - t) ** 2 * tr["b"] ** 2).sum() + (tr["b"] - 2.0) ** 2
        return one.expand(len(gens))

    kw = dict(steps=5, learning_rate=5e-2, grad_batch=3)
    ref = jx_optim.optimize_params({k: jnp.asarray(v) for k, v in init.items()}, jx_loss,
                                   jax.random.key(0), **kw)
    got = tc_optim.optimize_params({k: torch.tensor(v) for k, v in init.items()}, tc_loss,
                                   seed=0, **kw)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(ref.losses), **TOL)
    for k in init:
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(ref.params[k]), **TOL)
    assert float(got.losses[-1]) < float(got.losses[0])
