"""Port parity for `render/reparam.py::reparam_split_value_and_grad`, the
warped-area step with the reference's host-split signature, on
tests/test_reparam.py's `test_split_step_matches_monolithic` setting (the
emissive quad moving towards the camera at 32x32, `reparam_chunk` 256, the
loss mean(img^2)) with its tolerances, loss 1e-5 and gradient 1e-3
relative, and a boundary term above 1e-4: against the port's monolithic
`render_rgb(RenderConfig(reparam=True))` step on the same generators, and
against the JAX package's `reparam_split_value_and_grad` on the same
uniforms (JAX's draws for key 3 fed to the port in its draw order, as
tests/test_torch_reparam_render.py feeds them).  A second step draws the
same (the generators play the reference's key) and leaves the caller's
generators where they were; theta may be a dict of tensors; spp 2 and
`reparam_indirect` raise NotImplementedError, as in the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reparam_render import QUAD, _jax_draws, _jx_scene, injected  # noqa: F401

from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render.reparam import reparam_split_value_and_grad as jx_split
from fireflies_tpu_torch.render import RenderConfig, render_rgb
from fireflies_tpu_torch.render import types as tc
from fireflies_tpu_torch.render.reparam import reparam_split_value_and_grad

torch.set_num_threads(1)

FOV, HALF, Z = 60.0, 0.5, -2.0
EMISSION = torch.tensor([2.0, 1.0, 0.5])
CFG = RenderConfig(width=32, height=32, spp=1, max_bounces=1, tri_chunk=16, reparam=True,
                   reparam_k_aux=4, reparam_radius=0.06, reparam_chunk=256)
# The JAX package's Materials.default(1).
MATERIAL = dict(roughness=0.5, metallic=0.0, specular=0.5, spec_tint=0.0, clearcoat=0.0,
                clearcoat_gloss=1.0, sheen=0.0, sheen_tint=0.5, anisotropic=0.0, spec_trans=0.0,
                flatness=0.0, ior=1.5, thin=0.0)


def _scene(dz: torch.Tensor) -> tc.RenderScene:
    """The quad at z = Z + dz, emissive, seen by a 60-degree camera at the
    origin; one variant."""
    quad = torch.tensor([[-HALF, -HALF, Z], [HALF, -HALF, Z], [HALF, HALF, Z], [-HALF, HALF, Z]])
    verts = quad + torch.stack([0 * dz, 0 * dz, dz])
    mats = tc.Materials(**{f: torch.full((1, 1), v) for f, v in MATERIAL.items()},
                        base_color=torch.full((1, 1, 3), 0.8), emission=EMISSION[None, None])
    return tc.RenderScene(
        geometry=tc.Geometry(vertices=verts[None], faces=torch.tensor([[0, 1, 2], [0, 2, 3]]),
                             face_mat=torch.zeros(2, dtype=torch.long),
                             face_mesh=torch.zeros(2, dtype=torch.long)),
        materials=mats,
        lights=tc.Lights(kinds=(), to_world=torch.zeros(1, 0, 4, 4),
                         intensity=torch.zeros(1, 0, 3), cutoff_cos=torch.zeros(1, 0),
                         beam_cos=torch.zeros(1, 0), active=torch.zeros(1, 0, dtype=torch.bool)),
        camera=tc.Camera(to_world=torch.eye(4)[None], fov=torch.tensor([FOV]),
                         near=torch.tensor([0.01]), far=torch.tensor([1000.0])))


def _image_loss(img):
    return (img * img).mean()  # nonlinear: the value and gradient passes must not share draws


def _gens():
    return [torch.Generator().manual_seed(3)]


def test_split_step_matches_monolithic():
    dz = torch.tensor(0.0, requires_grad=True)
    l_mono = _image_loss(render_rgb(_scene(dz), _gens(), CFG))
    (g_mono,) = torch.autograd.grad(l_mono, dz)
    l_mono = l_mono.detach()

    gens = _gens()
    state = gens[0].get_state()
    step = reparam_split_value_and_grad(_scene, _image_loss, gens, CFG)
    l_split, g_split = step(torch.tensor(0.0))
    np.testing.assert_allclose(float(l_split), float(l_mono), rtol=1e-5)
    assert abs(float(g_mono)) > 1e-4  # the boundary term (a moving quad) is there
    np.testing.assert_allclose(float(g_split), float(g_mono), rtol=1e-3)

    # The same draws again; the caller's generators untouched; a dict theta.
    assert torch.equal(gens[0].get_state(), state)
    step = reparam_split_value_and_grad(lambda th: _scene(th["dz"]), _image_loss, gens, CFG)
    l_again, g_again = step({"dz": torch.tensor(0.0)})
    assert float(l_again) == float(l_split) and g_again.keys() == {"dz"}
    np.testing.assert_allclose(float(g_again["dz"]), float(g_split), rtol=1e-6)


def test_split_step_matches_jax(injected):
    key = jax.random.key(3)
    jx_cfg = JxConfig(width=32, height=32, spp=1, max_bounces=1, tri_chunk=16, reparam=True,
                      reparam_k_aux=4, reparam_radius=0.06, reparam_chunk=256)

    def jx_scene(dz):
        verts = jnp.asarray(QUAD) + jnp.stack([0 * dz, 0 * dz, dz])
        return _jx_scene(verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                         np.asarray(EMISSION)[None])

    l_jax, g_jax = jx_split(jx_scene, lambda img: jnp.mean(img * img), key, jx_cfg)(
        jnp.asarray(0.0))
    injected.extend(_jax_draws(key, CFG.width * CFG.height, CFG.reparam_k_aux))
    step = reparam_split_value_and_grad(_scene, _image_loss, _gens(), CFG)
    l_port, g_port = step(torch.tensor(0.0))
    assert not injected  # every draw was taken
    np.testing.assert_allclose(float(l_port), float(l_jax), rtol=1e-5)
    assert abs(float(g_jax)) > 1e-4
    np.testing.assert_allclose(float(g_port), float(g_jax), rtol=1e-3)


def test_split_step_refuses_what_it_cannot_split():
    for cfg in (CFG.replace(spp=2), CFG.replace(reparam_indirect=True)):
        with pytest.raises(NotImplementedError):
            reparam_split_value_and_grad(_scene, _image_loss, _gens(), cfg)
