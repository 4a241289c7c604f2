"""Port parity for the slice as a whole, beside tests/test_torch_render.py:
`pattern_step` on 2 variants of the vocalfold scene returns a finite,
nonzero gradient, and the second ported asset (a box under a point light,
no projector) renders alike in both packages (deterministic one-bounce
render, within 1e-4 of the image max on >= 99.9% of pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_render import H, W, _cfg

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import rays as tc_rays

torch.set_num_threads(2)


def test_pattern_step_gradient_is_finite():
    bridge, randomize, beams = main_path.build("cpu")
    loss, grad = main_path.pattern_step(bridge, randomize, beams, [0, 1], _cfg("torch", 2))
    assert grad.shape == (144, 3)
    assert torch.isfinite(loss) and torch.isfinite(grad).all()
    assert grad.abs().max() > 0


def test_hello_world_render_matches():
    """The second ported asset (a box under a point light, no projector):
    the same deterministic one-bounce render in both packages."""
    from fireflies_tpu_torch.assets import scenes as tc_scenes
    from fireflies_tpu_torch.render import SceneBridge as TcBridge

    js, kw = jx_scenes.hello_world()
    jp = {k: np.asarray(v) for k, v in jax.jit(js.compile())(jax.random.key(2), 0).items()}
    jscene = JxBridge(js, **kw).assemble({k: jnp.asarray(v) for k, v in jp.items()})
    ts, tkw = tc_scenes.hello_world()
    tscene = TcBridge(ts, **tkw).assemble(from_jax_params(jp, "cpu"))
    o, d, _ = jx_rays.camera_rays_tiled(jscene.camera, W, H, key=None)
    img_j = np.asarray(jax.jit(lambda s: jx_pt.trace_rays(
        s, o, d, jax.random.key(0), _cfg("jax", 1), primary_origin=s.camera.to_world[:3, 3]))(
            jscene))
    ot, dt, _ = tc_rays.camera_rays_tiled(tscene.camera, W, H)
    with torch.no_grad():
        img_t = tc_pt.trace_rays(tscene, ot, dt, None, _cfg("torch", 1),
                                 primary_origin=tscene.camera.to_world[:, :3, 3])[0].numpy()
    assert img_j.max() > 0
    bad = np.abs(img_t - img_j).max(axis=1) > 1e-4 * np.abs(img_j).max()
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} pixels differ"
