"""Port parity for the quadrature witness (render/quadrature.py) on the JAX
package's 24x24 film (tests/test_transport_quadrature.py), hello_world
without rotation and cornell_like from the reference's randomized
parameters (`interop.from_jax_params`):

  * one path vertex: the port's witness within 1e-5 of the reference's,
    and the port's own path tracer within 1e-5 of the port's witness (both
    compute the same deterministic integral: exact delta-light NEE, nothing
    drawn);
  * two vertices at n_mu=8, n_phi=16: within 1e-5 relative of the
    reference's (of the image's maximum);
  * hello_world is a convex box: depth 2 equals depth 1 in the witness and
    in the port's path tracer (no spurious indirect energy);
  * projectors, area lights and envmaps are refused with the reference's
    messages.
"""

import jax
import numpy as np
import pytest
import torch

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render.quadrature import radiance_quadrature as jx_quadrature
from fireflies_tpu.render.rays import camera_rays as jx_camera_rays
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import SceneBridge as TcBridge
from fireflies_tpu_torch.render.pathtracer import trace_rays
from fireflies_tpu_torch.render.quadrature import radiance_quadrature
from fireflies_tpu_torch.render.rays import camera_rays

torch.set_num_threads(2)

RES = 24
BUILDERS = {
    "hello_world": (lambda: jx_scenes.hello_world(randomize_rotation=False),
                    lambda: tc_scenes.hello_world(randomize_rotation=False)),
    "cornell_like": (jx_scenes.cornell_like, tc_scenes.cornell_like),
}


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, its rays, port scene, its rays), one set of
    parameters randomized by the reference at key 7 (as its test does)."""
    out = {}
    for name, (jx_build, tc_build) in BUILDERS.items():
        jscene, kw = jx_build()
        params = {k: np.asarray(v) for k, v in jscene.compile()(jax.random.key(7), 0).items()}
        jrs = JxBridge(jscene, **kw).assemble({k: jax.numpy.asarray(v) for k, v in params.items()})
        tscene, tkw = tc_build()
        trs = TcBridge(tscene, **tkw).assemble([from_jax_params(params, "cpu")])
        out[name] = (jrs, jx_camera_rays(jrs.camera, RES, RES), trs,
                     camera_rays(trs.camera, RES, RES))
    return out


def _cfg(bounces):
    return TcConfig(width=RES, height=RES, spp=1, max_bounces=bounces)


def test_depth1_matches_the_reference_and_the_path_tracer(scenes):
    for name, (jrs, (o_j, d_j), trs, (o, d)) in scenes.items():
        q_ref = np.asarray(jx_quadrature(jrs, o_j, d_j, max_bounces=1))
        q = radiance_quadrature(trs, o, d, max_bounces=1)
        assert q.shape == (1, RES * RES, 3) and q_ref.max() > 0, name
        np.testing.assert_allclose(q[0].numpy(), q_ref, rtol=0, atol=1e-5, err_msg=name)
        pt = trace_rays(trs, o, d, None, _cfg(1))
        np.testing.assert_allclose(pt.numpy(), q.numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_depth2_matches_the_reference(scenes):
    for name, (jrs, (o_j, d_j), trs, (o, d)) in scenes.items():
        q_ref = np.asarray(jx_quadrature(jrs, o_j, d_j, max_bounces=2, n_mu=8, n_phi=16))
        q = radiance_quadrature(trs, o, d, max_bounces=2, n_mu=8, n_phi=16)[0].numpy()
        np.testing.assert_allclose(q, q_ref, rtol=0, atol=1e-5 * np.abs(q_ref).max(),
                                   err_msg=name)


def test_convex_box_has_no_indirect_light(scenes):
    _, _, trs, (o, d) = scenes["hello_world"]
    q1 = radiance_quadrature(trs, o, d, max_bounces=1)
    q2 = radiance_quadrature(trs, o, d, max_bounces=2, n_mu=8, n_phi=16)
    torch.testing.assert_close(q2, q1, rtol=0, atol=1e-5)
    gens = [torch.Generator().manual_seed(3)]
    torch.testing.assert_close(trace_rays(trs, o, d, gens, _cfg(2)), q1, rtol=0, atol=1e-5)


def test_unsupported_emitters_are_refused(scenes):
    jrs, (o_j, d_j), trs, (o, d) = scenes["cornell_like"]
    geo = trs.geometry
    cases = {
        "area lights": (trs.replace(geometry=geo.replace(emissive_faces=torch.tensor([0]))),
                        o, d),
        "envmap background": (trs.replace(background=torch.ones(4, 8, 3)), o, d),
        "projector": _vocalfold(),
    }
    jx_cases = {
        "area lights": jrs.replace(geometry=jrs.geometry.replace(
            emissive_faces=jax.numpy.asarray([0]))),
        "envmap background": jrs.replace(background=jax.numpy.ones((4, 8, 3))),
    }
    for what, (scene, o_c, d_c) in cases.items():
        with pytest.raises(NotImplementedError, match=f"^quadrature witness: {what}$"):
            radiance_quadrature(scene, o_c, d_c, max_bounces=1)
    for what, scene in jx_cases.items():
        with pytest.raises(NotImplementedError, match=f"^quadrature witness: {what}$"):
            jx_quadrature(scene, o_j, d_j, max_bounces=1)


def _vocalfold():
    """(scene, o, d): the vocalfold scene with its projector, 8x8 rays."""
    bridge, randomize, beams = main_path.build("cpu", resolution=6)
    scene = main_path.scene_batch(bridge, randomize, beams, main_path.generators([0], "cpu"))
    return (scene, *camera_rays(scene.camera, 8, 8))
