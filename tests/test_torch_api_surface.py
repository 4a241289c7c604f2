"""The port's public surface against the JAX package's.

  * Every module of `fireflies_tpu` outside `render/pallas/`, read with
    `ast` in both packages: each public top-level name, each public member
    of a public class (methods, properties, dataclass fields, with the
    members of its base classes in the package) and each named argument of
    a public function or method has its counterpart at the same path in
    `fireflies_tpu_torch`.  A JAX `key`/`keys` argument is the port's
    random stream (`seed`, `gen`, `gens`, ...).  Each package `__init__`'s
    names (what it defines or imports from outside the standard library)
    are checked on a fresh import of the port's packages, which must build
    no library and touch no card.  `LEFT_OUT` holds the deliberate
    differences, one reason each (ROADMAP.md, "Left out on purpose"); an
    entry that matches nothing fails too.  A new public name in the JAX
    package needs its counterpart in the port or a line there.
  * The render types' factories and accessors against the JAX factories'
    values, exactly, with the port's leading variant axis stripped; the
    sampler accessors and `AnimationSampler`'s interval setters against
    the JAX samplers' `sample_eval` sweeps.
  * `assets.scenes.vocalfold(projector_texture=t)`: the projector the
    bridge assembles against the JAX bridge's from the same parameters,
    exactly, without rendering.
  * `optim.optimize_params` with an SGD-with-momentum factory against the
    JAX `optimize_params(optimizer=optax.sgd(lr, momentum))` on a quadratic
    over 20 steps, losses and parameters within 1e-5 relative; with no
    factory it is the default Adam bit for bit.
"""

import ast
import dataclasses
import fnmatch
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fireflies_tpu import optim as jx_optim
from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.render import types as jx_types
from fireflies_tpu.render.bridge import SceneBridge as JxBridge
from fireflies_tpu.sampling import base as jx_base
from fireflies_tpu.sampling import samplers as jx_samplers
from fireflies_tpu_torch import optim as tc_optim
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.render import types as tc_types
from fireflies_tpu_torch.render.bridge import SceneBridge as TcBridge
from fireflies_tpu_torch.sampling import base as tc_base
from fireflies_tpu_torch.sampling import samplers as tc_samplers

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "fireflies_tpu", "fireflies_tpu_torch"

# What the port leaves out on purpose: a pattern over "<module>::<name>",
# "<module>::<Class>.<member>" or "<module>::<function>(<argument>=)".
LEFT_OUT = {
    "*::Array": "the jax.Array alias; the port's modules alias torch.Tensor as `Tensor`",
    "*(backend=)": "JAX-only route switch; the tensors' device picks the port's route",
    "render/reparam.py::*(tri_chunk=)":
        "the JAX dense face scan's chunk; the port has `chunk` and `tile_cull`",
    "render/intersect.py::PALLAS_MAX_TRIS":
        "the FF_PALLAS_MAX_TRIS knob of the Pallas route; the face count picks the port's",
    "datagen/__init__.py::generate_dataset(eval_mode=)":
        "the JAX function takes it and never reads it",
    "datagen/__init__.py::generate_dataset_parallel(render_fn=)":
        "the port takes the batched `render_batch_fn` the farm takes",
    "render/integrators.py::random_depth_maps(n_maps=)": "the count is that of the generators",
    "render/reparam.py::*Domain.rays(u_flat=)":
        "the port's `u` keeps the (B, n, m, 2) layout, not a flat one",
    "parallel/__init__.py::NamedSharding": "a jax.sharding re-export",
    "parallel/__init__.py::P": "a jax.sharding re-export (PartitionSpec)",
}
# A JAX random key is a seed, a generator or a list of generators here.
RANDOM_STREAMS = {"seed", "seeds", "gen", "gens", "seed_or_gen"}


def _top(body):
    """Top-level statements, inside if/try blocks too."""
    for s in body:
        if isinstance(s, ast.If):
            yield from _top(s.body)
            yield from _top(s.orelse)
        elif isinstance(s, ast.Try):
            for part in (s.body, *(h.body for h in s.handlers), s.orelse, s.finalbody):
                yield from _top(part)
        else:
            yield s


def _params(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


class _Package:
    """One package's modules read with ast: name -> (kind, node or origin)."""

    def __init__(self, name):
        self.name, self.root = name, ROOT / name
        self._mods = {}

    def module(self, rel):
        if rel not in self._mods:
            path = self.root / rel
            bound = {}
            if path.exists():
                for s in _top(ast.parse(path.read_text()).body):
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                        bound[s.name] = ("def", s)
                    elif isinstance(s, (ast.Assign, ast.AnnAssign)):
                        for t in (s.targets if isinstance(s, ast.Assign) else [s.target]):
                            for n in ast.walk(t):
                                if isinstance(n, ast.Name):
                                    bound[n.id] = ("var", None)
                    elif isinstance(s, ast.ImportFrom) and s.module and s.level == 0:
                        top = s.module.split(".")[0]
                        if top != "__future__" and top not in sys.stdlib_module_names:
                            for al in s.names:
                                bound[al.asname or al.name] = ("import", (s.module, al.name))
            self._mods[rel] = bound if path.exists() else None
        return self._mods[rel]

    def resolve(self, rel, name, depth=0):
        """The def/class node `name` is bound to in module `rel`, following
        imports inside the package; None otherwise."""
        kind, what = (self.module(rel) or {}).get(name, (None, None))
        if kind == "def":
            return what
        if kind == "import" and depth < 8 and what[0].split(".")[0] == self.name:
            parts = what[0].split(".")[1:]
            for cand in ("/".join(parts) + ".py", "/".join(parts + ["__init__.py"])):
                if (self.root / cand).exists():
                    node = self.resolve(cand, what[1], depth + 1)
                    if node is not None:
                        return node
        return None

    def members(self, rel, cls, seen=()):
        """Members of class node `cls` (its own, then its package bases'):
        name -> argument list (None for fields)."""
        out = {}
        for s in cls.body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.setdefault(s.name, _params(s))
            elif isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
                out.setdefault(s.target.id, None)
            elif isinstance(s, ast.Assign):
                for t in s.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, None)
        for b in cls.bases:
            base = self.resolve(rel, b.id) if isinstance(b, ast.Name) else None
            if isinstance(base, ast.ClassDef) and base.name not in seen:
                for k, v in self.members(rel, base, seen + (cls.name,)).items():
                    out.setdefault(k, v)
        return out


def _missing_args(where, jx_args, tc_args):
    tc = set(tc_args)
    return [f"{where}({p}=)" for p in jx_args
            if p not in tc and not (p in ("key", "keys") and tc & RANDOM_STREAMS)]


def _surface_gaps(port_exports):
    """Every JAX public name, member or argument without its port
    counterpart, as "<module>::<path>"."""
    jx, tc = _Package(JAX_PKG), _Package(PORT_PKG)
    gaps = []
    for path in sorted(jx.root.rglob("*.py")):
        rel = path.relative_to(jx.root).as_posix()
        if rel.startswith("render/pallas/"):
            continue
        if tc.module(rel) is None:
            gaps.append(f"{rel}: no such module in the port")
            continue
        pkg = ".".join([PORT_PKG, *Path(rel).parent.parts])
        init = rel.endswith("__init__.py")
        for name, (kind, _) in jx.module(rel).items():
            if name.startswith("_") or (kind == "import" and not init):
                continue
            where = f"{rel}::{name}"
            there = port_exports[pkg] if init else set(tc.module(rel))
            if name not in there:
                gaps.append(where)
                continue
            jnode, tnode = jx.resolve(rel, name), tc.resolve(rel, name)
            if kind == "import" or jnode is None:
                continue
            if isinstance(jnode, ast.ClassDef):
                if not isinstance(tnode, ast.ClassDef):
                    gaps.append(f"{where} (not a class in the port)")
                    continue
                tm = tc.members(rel, tnode)
                for m, args in jx.members(rel, jnode).items():
                    if m.startswith("_"):
                        continue
                    if m not in tm:
                        gaps.append(f"{where}.{m}")
                    elif args is not None:
                        gaps += _missing_args(f"{where}.{m}", args, tm[m] or [])
            elif tnode is None or isinstance(tnode, ast.ClassDef):
                gaps.append(f"{where} (not a function in the port)")
            else:
                gaps += _missing_args(where, _params(jnode), _params(tnode))
    return gaps


def _fresh_exports(pkgs):
    """dir() of each port package on a fresh import (the modules already
    imported are set aside and put back), and whether that import built
    the native library or the kernels or initialized CUDA."""
    def ours(name):
        return name == PORT_PKG or name.startswith(PORT_PKG + ".")

    saved = {k: v for k, v in sys.modules.items() if ours(k)}
    for k in saved:
        del sys.modules[k]
    try:
        exports = {p: set(dir(importlib.import_module(p))) for p in pkgs}
        native = importlib.import_module(PORT_PKG + ".native")
        build = importlib.import_module(PORT_PKG + "._build")
        side_effects = (native.load_library.cache_info().currsize,
                        build.load_library.cache_info().currsize, torch.cuda.is_initialized())
    finally:
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    return exports, side_effects


def test_public_surface_matches_the_jax_package():
    pkgs = sorted(".".join([PORT_PKG, *p.relative_to(ROOT / JAX_PKG).parent.parts])
                  for p in (ROOT / JAX_PKG).rglob("__init__.py") if "pallas" not in p.parts)
    exports, side_effects = _fresh_exports(pkgs)
    assert side_effects == (0, 0, False), \
        "importing the port's packages built a library or touched the card"

    gaps = _surface_gaps(exports)
    used = {pat for pat in LEFT_OUT for g in gaps if fnmatch.fnmatchcase(g, pat)}
    unlisted = [g for g in gaps if not any(fnmatch.fnmatchcase(g, pat) for pat in LEFT_OUT)]
    assert not unlisted, ("the JAX package's public surface has no counterpart in "
                          "fireflies_tpu_torch (port it, or add a LEFT_OUT line with its "
                          "reason):\n  " + "\n  ".join(unlisted))
    stale = sorted(set(LEFT_OUT) - used)
    assert not stale, f"LEFT_OUT entries that match no difference: {stale}"


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_fields(tc_obj, jx_obj, fields, variant):
    for f in fields:
        got, ref = getattr(tc_obj, f), getattr(jx_obj, f)
        if ref is None:
            assert got is None, f
            continue
        got = _np(got)
        if got.ndim == np.asarray(ref).ndim + 1:
            got = got[variant]
        assert got.dtype == np.asarray(ref).dtype, f
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=f)


def test_factories_and_sampler_accessors_match():
    rng = np.random.default_rng(19)
    poses = rng.standard_normal((2, 4, 4)).astype(np.float32)
    assert (tc_types.LIGHT_POINT, tc_types.LIGHT_SPOT, tc_types.LIGHT_PROJECTOR,
            tc_types.LIGHT_AREA) == (jx_types.LIGHT_POINT, jx_types.LIGHT_SPOT,
                                     jx_types.LIGHT_PROJECTOR, jx_types.LIGHT_AREA)

    cam_fields = ("to_world", "fov", "near", "far")
    one = tc_types.Camera.create(torch.from_numpy(poses[0]), fov=60.0)
    assert one.to_world.shape == (1, 4, 4) and one.fov.shape == (1,)
    _same_fields(one, jx_types.Camera.create(poses[0], fov=60.0), cam_fields, 0)
    many = tc_types.Camera.create(torch.from_numpy(poses), 50.0, 0.1, 30.0)
    for b in range(2):
        _same_fields(many, jx_types.Camera.create(poses[b], 50.0, 0.1, 30.0), cam_fields, b)

    proj_fields = ("to_world", "fov", "near", "far", "texture", "scale", "aperture",
                   "beams_ndc", "beam_sigma", "beam_color", "beam_hw")
    tex = rng.uniform(0, 1, (5, 6, 3)).astype(np.float32)
    beams = rng.uniform(-1, 1, (7, 2)).astype(np.float32)
    cases = (dict(texture=tex, fov=25.0, scale=3.0, aperture=0.02),
             dict(texture=None, beams_ndc=beams, beam_sigma=4.0, beam_color=(1.0, 0.5, 0.0),
                  beam_hw=(64, 32)))
    for kw in cases:
        got = tc_types.Projector.create(torch.from_numpy(poses), **kw)
        for b in range(2):
            _same_fields(got, jx_types.Projector.create(poses[b], **kw), proj_fields, b)

    mats = tc_types.Materials.default(3, batch=2, device="cpu")
    jm = jx_types.Materials.default(3)
    assert mats.count == jm.count == 3
    for b in range(2):
        _same_fields(mats, jm, [f.name for f in dataclasses.fields(mats)], b)

    empty, je = tc_types.Lights.empty(batch=2, device="cpu"), jx_types.Lights.empty()
    assert empty.count == je.count == 0 and empty.kinds == ()
    for f in ("to_world", "intensity", "cutoff_cos", "beam_cos", "active"):
        assert _np(getattr(empty, f)).shape == (2, *getattr(je, f).shape), f
        assert _np(getattr(empty, f)).dtype == np.asarray(getattr(je, f)).dtype, f
    worlds = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    lights = empty.replace(kinds=(0, 1, 0), to_world=torch.from_numpy(worlds))
    assert lights.positions.shape == (2, 3, 3)
    for b in range(2):
        np.testing.assert_array_equal(_np(lights.positions[b]),
                                      np.asarray(je.replace(to_world=worlds[b]).positions))

    faces = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 0]])
    face_mesh = np.array([0, 2, 1])
    tg = tc_types.Geometry(vertices=torch.zeros(2, 4, 3), faces=torch.from_numpy(faces),
                           face_mat=torch.zeros(3, dtype=torch.long),
                           face_mesh=torch.from_numpy(face_mesh))
    jg = jx_types.Geometry(vertices=jnp.zeros((4, 3)), faces=jnp.asarray(faces, jnp.int32),
                           face_mat=jnp.zeros(3, jnp.int32),
                           face_mesh=jnp.asarray(face_mesh, jnp.int32))
    assert tg.num_faces == jg.num_faces == 3
    assert int(tg.num_meshes) == int(jg.num_meshes) == 3
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tc_types.Materials.default()

    # Samplers: intervals, accessors and eval sweeps.
    lo, hi = rng.uniform(-1, 0, 3).astype(np.float32), rng.uniform(0, 1, 3).astype(np.float32)
    for name in ("UniformSampler", "GaussianSampler", "UniformIntegerSampler"):
        js = getattr(jx_samplers, name).create(lo, hi, eval_step_size=0.125)
        ts = getattr(tc_samplers, name).create(lo, hi, eval_step_size=0.125)
        js, ts = js.set_sample_interval(lo * 2, hi * 3), ts.set_sample_interval(lo * 2, hi * 3)
        assert ts.shape == js.shape == (3,)
        np.testing.assert_array_equal(ts.get_min(), js.get_min())
        np.testing.assert_array_equal(ts.get_max(), js.get_max())
        for step in range(12):
            np.testing.assert_array_equal(_np(ts.sample_eval(step, "cpu")),
                                          np.asarray(js.sample_eval(jnp.int32(step))))
    jc, tcs = jx_base.ConstantSampler.of(2.5), tc_base.ConstantSampler.of(2.5)
    assert tcs.shape == jc.shape == (1,)
    np.testing.assert_array_equal(tcs.get_min(), jc.get_min())
    np.testing.assert_array_equal(tcs.get_max(), jc.get_max())

    ja, ta = jx_samplers.AnimationSampler.create(0, 10, 2, 6), \
        tc_samplers.AnimationSampler.create(0, 10, 2, 6)
    ja2 = ja.set_train_interval(1, 4).set_eval_interval(3, 9)
    ta2 = ta.set_train_interval(1, 4).set_eval_interval(3, 9)
    assert (ta.train_min, ta.train_max, ta.eval_min, ta.eval_max) == (0, 10, 2, 6)
    assert (ta2.train_min, ta2.train_max, ta2.eval_min, ta2.eval_max) == tuple(
        int(getattr(ja2, f)) for f in ("train_min", "train_max", "eval_min", "eval_max"))
    for step in range(14):
        assert int(ta2.sample_eval(step, "cpu")) == int(ja2.sample_eval(jnp.int32(step)))
    gen = torch.Generator().manual_seed(0)
    draws = [int(ta2.sample_train(gen, "cpu")) for _ in range(32)]
    assert min(draws) >= 1 and max(draws) < 4


def test_vocalfold_projector_texture_matches_the_jax_bridge():
    rng = np.random.default_rng(7)
    tex = rng.uniform(0, 1, (6, 10, 3)).astype(np.float32)
    js, jkw = jx_scenes.vocalfold(resolution=4, n_anim_frames=2, projector_texture=tex)
    ts, tkw = tc_scenes.vocalfold(resolution=4, n_anim_frames=2, projector_texture=tex)
    assert set(tkw) == set(jkw) and tkw["projector_texture"] is tex
    tp = ts.compile("cpu")(torch.Generator().manual_seed(0), 0)
    jp = JxBridge(js, **jkw).assemble({k: jnp.asarray(_np(v)) for k, v in tp.items()}).projector
    got = TcBridge(ts, **tkw).assemble([tp, tp]).projector
    assert got.texture.shape == (6, 10, 3) and got.beams_ndc is None
    np.testing.assert_array_equal(_np(got.texture), np.asarray(jp.texture))
    np.testing.assert_array_equal(_np(got.texture), tex)
    _same_fields(got, jp, ("to_world", "fov", "near", "far", "scale"), 1)
    # Without the argument the bridge's default texture stays.
    ts0, tkw0 = tc_scenes.vocalfold(resolution=4, n_anim_frames=2)
    assert "projector_texture" not in tkw0


def test_optimize_params_takes_an_optimizer_factory():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.standard_normal(6).astype(np.float32)
    init = {"x": rng.standard_normal(4).astype(np.float32), "s": np.float32(0.3)}
    lr, momentum, steps = 2e-2, 0.9, 20

    def jx_loss(tr, key):
        return jnp.sum((a @ tr["x"] - y) ** 2) + 3.0 * (tr["s"] - 1.5) ** 2

    def tc_loss(tr, gens):
        r = torch.from_numpy(a) @ tr["x"] - torch.from_numpy(y)
        return ((r ** 2).sum() + 3.0 * (tr["s"] - 1.5) ** 2).expand(len(gens))

    ref = jx_optim.optimize_params({k: jnp.asarray(v) for k, v in init.items()}, jx_loss,
                                   jax.random.key(0), steps=steps,
                                   optimizer=optax.sgd(lr, momentum))
    got = tc_optim.optimize_params(
        {k: torch.tensor(v) for k, v in init.items()}, tc_loss, steps=steps,
        optimizer=lambda p: torch.optim.SGD(p, lr=lr, momentum=momentum))
    assert got.losses.shape == (steps,)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(ref.losses), rtol=1e-5)
    for k in init:
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(ref.params[k]), rtol=1e-5)
    assert float(got.losses[-1]) < float(got.losses[0])

    default = tc_optim.optimize_params({k: torch.tensor(v) for k, v in init.items()}, tc_loss,
                                       steps=5, learning_rate=lr)
    adam = tc_optim.optimize_params(
        {k: torch.tensor(v) for k, v in init.items()}, tc_loss, steps=5,
        optimizer=lambda p: torch.optim.Adam(p, lr=lr))
    assert torch.equal(default.losses, adam.losses)
    for k in init:
        assert torch.equal(default.params[k], adam.params[k])
