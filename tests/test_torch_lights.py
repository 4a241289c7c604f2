"""Port parity: the spot light, the beam-splat projector and the laser
pattern against the JAX functions, on random points made with numpy and fed
to both packages.  Tolerances as tests/test_torch_shading.py (1e-5
relative, 1e-6 absolute, or 1e-5 of the largest value on a spot light's
falloff ramp and the projector's splat); the laser pattern and beam
parameters to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_shading import N, _close, _v

from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import lights as jx_lights
from fireflies_tpu.render import types as jx_types
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import lights as tc_lights
from fireflies_tpu_torch.render import types as tc_types
from fireflies_tpu_torch.render import vec3 as tc_vec3

torch.set_num_threads(1)


def _look_at(origin, target):
    from fireflies_tpu_torch.utils.math import look_at_np
    return look_at_np(origin, target)


def test_spot_light_matches():
    rng = np.random.default_rng(7)
    p = rng.uniform(-2.0, 2.0, size=(N, 3)).astype(np.float32) * [1.0, 1.0, 0.15]
    to_world = _look_at((0.0, 0.0, 1.95), (0.0, 0.0, 0.0))
    cut, beam = np.cos(np.deg2rad(40.0)), np.cos(np.deg2rad(30.0))
    lj = jx_types.Lights(
        kinds=jnp.asarray([jx_types.LIGHT_SPOT]), to_world=jnp.asarray(to_world[None]),
        intensity=jnp.full((1, 3), 12.0), cutoff_cos=jnp.asarray([cut], jnp.float32),
        beam_cos=jnp.asarray([beam], jnp.float32), active=jnp.ones((1,), bool))
    lt = tc_types.Lights(
        kinds=(tc_types.LIGHT_SPOT,), to_world=torch.as_tensor(to_world)[None, None],
        intensity=torch.full((1, 1, 3), 12.0),
        cutoff_cos=torch.tensor([[cut]], dtype=torch.float32),
        beam_cos=torch.tensor([[beam]], dtype=torch.float32),
        active=torch.ones((1, 1), dtype=torch.bool))
    pt = tc_vec3.from_array(torch.as_tensor(p)[None])
    wi_t, dist_t, rad_t = tc_lights.eval_light_v(lt, 0, pt)
    wi_j, dist_j, rad_j = jx_lights.eval_light_v(lj, 0, _v(p, "jax"))
    _close(wi_t.to_array()[0], wi_j.to_array())
    _close(dist_t[0], dist_j)
    _close(rad_t.to_array()[0], rad_j.to_array(), ill_conditioned=True)
    assert float(rad_t.max_component().min()) == 0.0  # some points fall outside the cone


def test_beam_projector_matches():
    rng = np.random.default_rng(8)
    p = rng.uniform(-0.6, 0.6, size=(N, 3)).astype(np.float32) * [1.0, 1.0, 0.3]
    to_world = _look_at((0.35, 0.0, 1.9), (0.0, 0.0, 0.0))
    beams = rng.uniform(-0.8, 0.8, size=(144, 2)).astype(np.float32)
    pj = jx_types.Projector.create(jnp.asarray(to_world), None, fov=30.0, scale=20.0,
                                   beams_ndc=jnp.asarray(beams), beam_sigma=10.0,
                                   beam_color=(0.0, 1.0, 0.0), beam_hw=(256, 256))
    pt = tc_types.Projector(
        to_world=torch.as_tensor(to_world)[None], fov=torch.tensor([30.0]),
        near=torch.tensor([0.01]), far=torch.tensor([1000.0]), texture=None,
        scale=torch.tensor([20.0]), beams_ndc=torch.as_tensor(beams)[None],
        beam_sigma=torch.tensor([10.0]), beam_color=torch.tensor([[0.0, 1.0, 0.0]]),
        beam_hw=(256, 256))
    wi_t, dist_t, rad_t = tc_lights.eval_projector_v(pt, tc_vec3.from_array(torch.as_tensor(p)[None]))
    wi_j, dist_j, rad_j = jx_lights.eval_projector_v(pj, _v(p, "jax"))
    _close(wi_t.to_array()[0], wi_j.to_array())
    _close(dist_t[0], dist_j)
    _close(rad_t.to_array()[0], rad_j.to_array(), ill_conditioned=True)
    assert float(rad_t.y.max()) > 0.0


def test_laser_pattern_matches():
    rays_t = tc_laser.generate_uniform_rays(0.0275, 12, 12, device="cpu")
    rays_j = jx_laser.generate_uniform_rays(0.0275, 12, 12)
    assert rays_t.shape == (144, 3)
    np.testing.assert_allclose(rays_t.numpy(), np.asarray(rays_j), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(37, 3)).astype(np.float32) * [0.2, 0.2, 1.0]
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    bp_t = tc_laser.rays_to_beam_params(torch.as_tensor(d), 30.0, sigma=7.0,
                                        texture_size=(128, 64))
    bp_j = jx_laser.rays_to_beam_params(jnp.asarray(d), 30.0, sigma=7.0, texture_size=(128, 64))
    assert set(bp_t) == set(bp_j)
    assert bp_t["tex.beam_hw"] == bp_j["tex.beam_hw"]
    for k in ("tex.beams", "tex.beam_sigma", "tex.beam_color"):
        np.testing.assert_allclose(bp_t[k].numpy(), np.asarray(bp_j[k]), rtol=1e-6, atol=1e-6)
