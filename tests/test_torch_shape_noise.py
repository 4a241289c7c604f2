"""Port parity: shape models, the Perlin texture sampler and the profiling
helpers against the JAX package.

`lbs` on tests/test_shape_model_lbs.py's synthetic 3-joint rig within 1e-5
and its pose gradient against `jax.grad` within 1e-4; `FlameShapeModel`
from synthetic `.npz` archives (`parents` or `kintree_table`); the drift
walk in eval mode and in train mode from JAX's own start within 1e-6;
`rand_perlin_2d`, its octaves and `NoiseTextureLerpSampler` fed JAX's draws
(its key split as JAX splits it) within 1e-6.  Also `utils.profiling`, and
that no module of the port imports jax, flax, yaml or the JAX package.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.entity.shape_model import FlameShapeModel as JxFlame
from fireflies_tpu.entity.shape_model import ShapeModel as JxShape
from fireflies_tpu.sampling import noise_texture_lerp as jx_noise
from fireflies_tpu.utils import profiling as jx_profiling
from fireflies_tpu_torch.entity.shape_model import FlameShapeModel as TcFlame
from fireflies_tpu_torch.entity.shape_model import ShapeModel as TcShape
from fireflies_tpu_torch.sampling import noise_texture_lerp as tc_noise
from fireflies_tpu_torch.utils import profiling as tc_profiling
from test_shape_model_lbs import _toy_flame_npz


def test_lbs_and_flame_match_jax(tmp_path):
    path, template = _toy_flame_npz(tmp_path)
    data = dict(np.load(path))
    kintree = tmp_path / "kintree.npz"
    parents = data.pop("parents")
    np.savez(kintree, **data, kintree_table=np.stack([np.where(parents < 0, 7, parents),
                                                      np.arange(3)]))
    rng = np.random.default_rng(2)
    params = rng.normal(0, 0.5, 4).astype(np.float32)
    pose = rng.normal(0, 0.4, (3, 3)).astype(np.float32)
    weights = rng.normal(size=template.shape).astype(np.float32)
    for p in (path, kintree):
        jm, tm = JxFlame("head", str(p), n_shape=2, n_expr=2), TcFlame("head", str(p), 2, 2)
        assert tm.has_pose() and tm.n_joints == 3 and tm.n_params() == jm.n_params() == 4
        np.testing.assert_array_equal(tm._parents, jm._parents)
        jv = np.asarray(jm.get_vertex_data(jnp.asarray(params), jnp.asarray(pose)))
        pose_t = torch.tensor(pose, requires_grad=True)
        tv = tm.get_vertex_data(torch.tensor(params), pose_t)
        np.testing.assert_allclose(tv.detach().numpy(), jv, atol=1e-5)
        np.testing.assert_allclose(tm.get_vertex_data(torch.tensor(params)).numpy(),
                                   np.asarray(jm.get_vertex_data(jnp.asarray(params))),
                                   atol=1e-6)
        (tv * torch.from_numpy(weights)).sum().backward()
        jg = jax.grad(lambda q: jnp.sum(jm.get_vertex_data(jnp.asarray(params), q) * weights))(
            jnp.asarray(pose))
        np.testing.assert_allclose(pose_t.grad.numpy(), np.asarray(jg), atol=1e-4)
    # The blend shapes' gradient to the parameters: the basis contracted
    # with the weights.
    params_t = torch.tensor(params, requires_grad=True)
    (tm.get_vertex_data(params_t) * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(params_t.grad.numpy(),
                               np.einsum("kvc,vc->k", tm._basis, weights), rtol=1e-5)


def test_shape_model_drift_matches_jax():
    rng = np.random.default_rng(3)
    template = rng.normal(size=(5, 3)).astype(np.float32)
    basis = rng.normal(size=(6, 5, 3)).astype(np.float32)
    jm = JxShape("mesh-shape", template, basis, param_limit=0.5, drift=0.05, n_active=4)
    tm = TcShape("mesh-shape", template, basis, param_limit=0.5, drift=0.05, n_active=4)
    key = jax.random.key(11)
    start = jax.random.uniform(key, (6,), minval=-0.5, maxval=0.5)
    for step in (0, 1, 7, 23, 40, 101):
        for train in (False, True):
            jp = np.asarray(jm.sample_params(key, step, train))
            tp = tm.sample_params(None, step, train, "cpu", start=torch.from_numpy(
                np.asarray(start)))
            np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6)
            assert np.all(np.abs(tp.numpy()) <= 0.5 + 1e-6) and np.all(tp.numpy()[4:] == 0)
        np.testing.assert_allclose(
            tm.sample_local_vertices(None, step, False, "cpu").numpy(),
            np.asarray(jm.sample_local_vertices(key, step, False)), atol=1e-6)
    drawn = tm.sample_params(torch.Generator().manual_seed(0), 0, True, "cpu")
    assert drawn.shape == (6,) and float(drawn.abs().max()) <= 0.5


def _jax_draws(sampler, key):
    k_res, k_oct, k_per, k_noise = jax.random.split(key, 4)
    n_res = len(jx_noise._RES_EXPONENTS)
    max_res = max(min(sampler.texture_shape) // 2, 1)
    angles = [np.asarray(2 * jnp.pi * jax.random.uniform(jax.random.fold_in(k_noise, i),
                                                          (r + 1, r + 1)))
              for i, r in enumerate(min(2**e, max_res) for e in jx_noise._RES_EXPONENTS)]
    return (int(jax.random.randint(k_res, (), 0, n_res)),
            int(jax.random.randint(k_oct, (), 1, jx_noise._MAX_OCTAVES + 1)),
            float(jax.random.uniform(k_per, (), minval=0.1, maxval=2.0)), angles)


def test_perlin_and_sampler_match_jax():
    for shape, res in (((32, 32), (4, 4)), ((24, 48), (3, 8)), ((64, 64), (32, 32))):
        key = jax.random.key(sum(res))
        angles = np.asarray(2 * jnp.pi * jax.random.uniform(key, (res[0] + 1, res[1] + 1)))
        np.testing.assert_allclose(
            tc_noise.rand_perlin_2d(None, shape, res, angles=angles).numpy(),
            np.asarray(jx_noise.rand_perlin_2d(key, shape, res)), atol=1e-6)
    key = jax.random.key(5)
    octave_angles = [np.asarray(2 * jnp.pi * jax.random.uniform(jax.random.fold_in(key, k),
                                                                (min(2 * 2**k, 16) + 1,) * 2))
                     for k in range(4)]
    np.testing.assert_allclose(
        tc_noise.rand_perlin_2d_octaves(None, (32, 32), (2, 2), 4, 0.7,
                                        angles=octave_angles).numpy(),
        np.asarray(jx_noise.rand_perlin_2d_octaves(key, (32, 32), (2, 2), 4, 0.7)), atol=1e-6)
    for shape in ((32, 32), (64, 16)):
        colors = ([1.0, 0.0, 0.0], [0.9, 0.1, 0.0])
        js = jx_noise.NoiseTextureLerpSampler.create(*colors, texture_shape=shape)
        ts = tc_noise.NoiseTextureLerpSampler.create(*colors, texture_shape=shape)
        for seed in range(2):
            key = jax.random.key(seed)
            mine = ts.texture(*_jax_draws(js, key), device="cpu")
            np.testing.assert_allclose(mine.numpy(), np.asarray(js.sample_train(key)), atol=1e-6)
        tex = ts.sample(torch.Generator().manual_seed(0), 0, True, "cpu")
        assert tex.shape == (3, *shape) and float(tex[0].min()) >= 0.9 - 1e-6
        torch.testing.assert_close(ts.sample(None, 3, False, "cpu"),
                                   ts.sample(None, 3, False, "cpu"), rtol=0, atol=0)


def test_profiling_and_port_imports(tmp_path, capsys):
    stats = tc_profiling.time_it(lambda x: x * 2, torch.ones(16), repeats=3)
    assert 0 < stats["min_s"] <= stats["median_s"] <= stats["max_s"] and stats["repeats"] == 3
    for mod, name in ((tc_profiling, "tc.jsonl"), (jx_profiling, "jx.jsonl")):
        logger = mod.MetricsLogger(tmp_path / name, echo=False)
        logger.log(0, loss=1.5)
        logger.log(1, loss=np.float32(0.5), renders_per_sec=3)
    lines = [[json.loads(x) for x in (tmp_path / n).read_text().splitlines()]
             for n in ("tc.jsonl", "jx.jsonl")]
    for mine, theirs in zip(*lines):
        assert list(mine) == list(theirs) and mine["step"] == theirs["step"]
        assert {k: v for k, v in mine.items() if k != "wall_s"} == {
            k: v for k, v in theirs.items() if k != "wall_s"}
    tp = tc_profiling.Throughput()
    tp.add(4)
    assert tp.per_second > 0
    with tc_profiling.debug_nans():
        x = torch.tensor(-1.0, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    torch.sqrt(torch.tensor(-1.0, requires_grad=True)).backward()  # unchecked outside
    with tc_profiling.trace(tmp_path / "trace"):
        torch.ones(8).cumsum(0)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
    # The port stands alone: no module imports JAX, Flax, PyYAML or the
    # JAX package.
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|yaml|fireflies_tpu)\b", re.M)
    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "fireflies_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 50
    assert [str(f) for f in files if banned.search(f.read_text())] == []
