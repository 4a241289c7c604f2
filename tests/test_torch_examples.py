"""The example scripts' torch twins (examples_torch/) against examples/.

  * `render_randomized_variants` on hello_world, 4 variants at 16x16,
    spp 64, in both packages: the scene in eval mode, so that variant i's
    randomization is the deterministic sweep at step i in both (a rotation
    of the cube), and only the render's draws differ (the port's
    generators against JAX's keys).  The mean of the four images within 1%
    of JAX's (two port renders with other seeds differ by up to 0.4% a
    variant), and the mean over pixels of |port - JAX| within 4 standard
    errors of the mean of |port - port'|, a second, independently seeded
    render: both pairs differ by the Monte Carlo noise alone when the two
    packages estimate the same image;
  * the cheap scripts run in-process on the CPU (FIREFLIES_DEVICE=cpu) at
    EXAMPLE_SIZE 16, 2 variants, 2 steps, 4 frames: each writes its PNGs
    and files (examples_torch/_common.py's OUTPUTS) and every number it
    prints is finite;
  * without a card and without FIREFLIES_DEVICE each script raises before
    it renders; nothing falls back to the CPU;
  * no file of examples_torch/ imports jax, optax or fireflies_tpu, and the
    directory holds the 17 files of examples/.
"""

import ast
import contextlib
import importlib.util
import io
import math
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TWINS = ROOT / "examples_torch"
SCRIPTS = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
# The scripts cheap enough for the CPU at EXAMPLE_SIZE 16 (the others train
# a fixed 150-350 steps: 08, 09 and 13, or render 4 SMARTY depth maps and
# Bridson at 128x128: 10); what each writes is examples_torch/_common.py's
# OUTPUTS.
CHEAP = ("01_hello_world.py", "02_general_transformations.py", "03_parent_child.py",
         "04_material_randomization.py", "05_light_randomization.py", "06_animation.py",
         "06_sampling.py", "07_gradient_accumulation.py", "11_domain_specific_pattern_optim.py",
         "12_multichip_scaleout.py", "14_analytic_projector.py", "vocalfold_scene.py")
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf", re.IGNORECASE)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def twins(monkeypatch, tmp_path):
    """`run(name)` runs examples_torch/<name> as __main__ and returns what it
    printed.  Its first call imports the scripts' `_common` afresh (it reads
    the EXAMPLE_* variables at import) with `out_dir` under tmp_path."""
    monkeypatch.delitem(sys.modules, "_common", raising=False)

    def out_dir(name):
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        return d

    def run(name):
        if "_common" not in sys.modules:
            common = _load(TWINS / "_common.py", "_common")
            common.out_dir = out_dir
            sys.modules["_common"] = common
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(TWINS / name), run_name="__main__")
        return out.getvalue()

    yield run, tmp_path
    sys.modules.pop("_common", None)


def test_render_randomized_variants_matches_jax(monkeypatch):
    monkeypatch.setenv("FIREFLIES_DEVICE", "cpu")
    jx_common = _load(ROOT / "examples" / "_common.py", "_jax_examples_common")
    from fireflies_tpu.assets import scenes as jx_scenes

    tc_common = _load(TWINS / "_common.py", "_tc_examples_common")
    from fireflies_tpu_torch.assets import scenes as tc_scenes

    n, size, spp = 4, 16, 64
    jx_scene, jx_kw = jx_scenes.hello_world()
    jx_scene.eval()
    img_j = np.asarray(jx_common.render_randomized_variants(jx_scene, jx_kw, n=n, size=size,
                                                            spp=spp))
    tc_scene, tc_kw = tc_scenes.hello_world()
    tc_scene.eval()
    img_t = [tc_common.render_randomized_variants(tc_scene, tc_kw, n=n, size=size, spp=spp,
                                                  seed=seed).numpy() for seed in (0, 1)]
    assert img_j.shape == img_t[0].shape == (n, size, size, 3)
    assert np.isfinite(img_t[0]).all() and img_t[0].max() > 0.1
    assert abs(img_t[0].mean() - img_j.mean()) <= 0.01 * img_j.mean()
    # Two independent port renders differ by the noise of two renders; the
    # port's render against JAX's by the same, if both estimate one image.
    spread = np.abs(img_t[0] - img_t[1]).reshape(n, -1)
    diff = np.abs(img_t[0] - img_j).reshape(n, -1)
    se = np.hypot(spread.std(axis=1), diff.std(axis=1)) / math.sqrt(spread.shape[1])
    assert (np.abs(diff.mean(axis=1) - spread.mean(axis=1)) <= 4.0 * se).all(), (
        diff.mean(axis=1), spread.mean(axis=1), se)


def test_cheap_examples_run_on_the_cpu(twins, monkeypatch):
    for key, value in (("FIREFLIES_DEVICE", "cpu"), ("EXAMPLE_SIZE", "16"),
                       ("EXAMPLE_VARIANTS", "2"), ("EXAMPLE_STEPS", "2"),
                       ("EXAMPLE_FRAMES", "4")):
        monkeypatch.setenv(key, value)
    run, out = twins
    for name in CHEAP:
        printed = run(name)
        values = [float(x) for x in NUMBER.findall(printed.replace(str(out), ""))]
        assert values and all(math.isfinite(v) for v in values), (name, printed)
        subdir, n_png, files = sys.modules["_common"].OUTPUTS[name]
        pngs = list((out / subdir).glob("*.png"))
        assert len(pngs) >= n_png, (name, sorted(p.name for p in pngs))
        for f in files:
            assert (out / subdir / f).stat().st_size, (name, f)


def test_examples_raise_without_a_card(twins, monkeypatch):
    monkeypatch.delenv("FIREFLIES_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run, out = twins
    for name in SCRIPTS:
        if name == "_common.py":
            continue
        with pytest.raises(RuntimeError, match="FIREFLIES_DEVICE"):
            run(name)
    assert not list(out.rglob("*.png"))


def test_examples_import_no_jax():
    names = sorted(p.name for p in TWINS.glob("*.py"))
    assert names == SCRIPTS and len(names) == 17
    banned = {"jax", "jaxlib", "optax", "flax", "fireflies_tpu"}
    for name in names:
        tree = ast.parse((TWINS / name).read_text(), filename=name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, (name, mod)


def _ex13(package: str, seed: int, dxs: list[float], keys: int, device: str) -> dict:
    """Example 13 of `package` ("jax": examples/, on the CPU; "torch":
    examples_torch/, on `device`) with every seed it draws moved by
    1000 * seed (seed 0 is the script as it stands): the dx its 120 Adam
    steps recover, then, when `dxs` is given, the mean and standard error
    over `keys` draws of d loss / d dx at each of `dxs`, the fixed target
    at 0.3, other draws than its training."""
    import tempfile

    src = ROOT / ("examples" if package == "jax" else "examples_torch")
    sys.path.insert(0, str(src))
    sys.modules.pop("_common", None)
    if package == "torch":
        import os

        os.environ["FIREFLIES_DEVICE"] = device
    mod = _load(src / "13_warped_area_gradients.py", "_ex13")
    tmp = Path(tempfile.mkdtemp())
    mod.out_dir = lambda name: tmp
    if package == "jax":
        import jax
        import jax.numpy as jnp

        key = jax.random.key
        jax.random.key = lambda s: key(s + 1000 * seed)
    else:
        from fireflies_tpu_torch.utils.seeds import step_generators

        generator = mod.generator
        mod.generator = lambda s, dev: generator(s + 1000 * seed, dev)
        mod.step_generators = lambda s, i, n, dev: step_generators(s + 1000 * seed, i, n, dev)
    out, held = io.StringIO(), True
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    except AssertionError:
        held = False
    finally:
        if package == "jax":
            jax.random.key = key
    (dx,) = re.findall(r"recovered dx=(\S+)", out.getvalue())
    res = {"package": package, "device": "cpu" if package == "jax" else device, "seed": seed,
           "dx": float(dx), "assertion_held": held, "witness": []}
    cfg = mod.RenderConfig(width=mod.RES, height=mod.RES, tri_chunk=16)
    if package == "jax" and dxs:
        target = mod.render_depth_reparam(mod.make_scene(jnp.asarray(0.3)), cfg, key(99))
        grad = jax.jit(jax.grad(lambda dx, k: jnp.mean((mod.render_depth_reparam(
            mod.make_scene(dx), cfg, k, k_aux=8, radius=0.08) - target) ** 2)))
    for dx0 in dxs:
        if package == "jax":
            gs = [float(grad(jnp.asarray(dx0), jax.random.fold_in(key(7), k)))
                  for k in range(keys)]
        else:
            dev = torch.device(device)
            with torch.no_grad():
                target = mod.render_depth_reparam(
                    mod.make_scene(torch.tensor(0.3, device=dev), dev), cfg, generator(99, dev))
            gs = []
            for k in range(keys):
                dx = torch.tensor(dx0, device=dev, requires_grad=True)
                depth = mod.render_depth_reparam(mod.make_scene(dx, dev), cfg,
                                                 step_generators(7, k, 1, dev), k_aux=8,
                                                 radius=0.08)
                ((depth - target) ** 2).mean().backward()
                gs.append(dx.grad.item())
        res["witness"].append({"dx": dx0, "grad_mean": float(np.mean(gs)),
                               "grad_se": float(np.std(gs) / math.sqrt(len(gs))), "n": len(gs)})
    sys.path.remove(str(src))
    return res


if __name__ == "__main__":
    # The spread of example 13 over seeds, and its gradient's mean near the
    # target, in either package (the JAX one on the CPU):
    #   python tests/test_torch_examples.py jax 1 2 3
    #   python tests/test_torch_examples.py torch --device cuda 0 1 2 3 --witness 0.2,0.25,0.3
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--witness", default="", help="comma-separated dx at which to average "
                    "the gradient (after the first seed's run)")
    ap.add_argument("--keys", type=int, default=16)
    args = ap.parse_args()
    dxs = [float(x) for x in args.witness.split(",") if x]
    for i, s in enumerate(args.seeds):
        print(json.dumps(_ex13(args.package, s, dxs if i == 0 else [], args.keys, args.device)),
              flush=True)
