"""Shared helpers for the example scripts, the PyTorch twins of examples/.

Each script does what its namesake in examples/ does, headless: it renders
randomized variants and writes PNGs to examples_torch/output/<name>/.
Sizes come from the same variables as there: EXAMPLE_SIZE,
EXAMPLE_VARIANTS, EXAMPLE_STEPS, EXAMPLE_FRAMES and EXAMPLE_PER_DEVICE.

The device comes from FIREFLIES_DEVICE: `cuda` (the default) runs on the
card, `cpu` on the CPU (the plain versions of the kernels).  Asking for
`cuda` on a machine without a card raises; nothing falls back.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from fireflies_tpu_torch.datagen import tonemap  # noqa: E402
from fireflies_tpu_torch.utils.png import write_png  # noqa: E402
from fireflies_tpu_torch.utils.seeds import step_seeds  # noqa: E402

SIZE = int(os.environ.get("EXAMPLE_SIZE", 128))
N_VARIANTS = int(os.environ.get("EXAMPLE_VARIANTS", 4))

# What each script writes under output/ at the EXAMPLE_* settings in force:
# (subdirectory, PNG images at least, other files).
OUTPUTS = {
    **{name + ".py": (name, N_VARIANTS, ()) for name in (
        "01_hello_world", "02_general_transformations", "03_parent_child",
        "04_material_randomization", "05_light_randomization", "06_animation", "06_sampling")},
    "07_gradient_accumulation.py": ("07_gradient_accumulation", 0, ("result.txt",)),
    "08_optimization.py": ("08_optimization", 0, ("result.txt",)),
    "09_point_pattern_optimization.py": ("09_point_pattern_optimization", 2, ("points.npy",)),
    "10_pattern_creation.py": ("10_pattern_creation", 4, ("laser_smarty.yml",)),
    "11_domain_specific_pattern_optim.py": ("11_domain_specific_pattern_optim", 3, ()),
    "12_multichip_scaleout.py": (
        "12_multichip_scaleout", min(4, int(os.environ.get("EXAMPLE_PER_DEVICE", 2))), ()),
    "13_warped_area_gradients.py": ("13_warped_area_gradients", 3, ()),
    "14_analytic_projector.py": ("14_analytic_projector", 3, ("rays.npy",)),
    "vocalfold_scene.py": ("vocalfold_dataset/images", int(os.environ.get("EXAMPLE_FRAMES", 8)),
                           ()),
}


def device() -> torch.device:
    """The device FIREFLIES_DEVICE names (default `cuda`)."""
    dev = torch.device(os.environ.get("FIREFLIES_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("FIREFLIES_DEVICE asks for cuda, but torch sees no CUDA device; "
                           "set FIREFLIES_DEVICE=cpu to run on the CPU")
    return dev


def out_dir(name: str) -> Path:
    d = Path(__file__).resolve().parent / "output" / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def save_variants(name: str, images, prefix: str = "variant") -> None:
    d = out_dir(name)
    for i, img in enumerate(images.cpu().numpy()):
        write_png(str(d / f"{prefix}_{i:02d}.png"), img)
    print(f"[{name}] wrote {len(images)} images to {d}")


def render_randomized_variants(scene, bridge_kwargs, n=N_VARIANTS, size=SIZE, spp=2,
                               bounces=2, extra_params=None, seed=0):
    """randomize -> render shared by examples 01-06: variant i randomized at
    step i from its own generator (seeded step_seeds(seed, 0, n)[i]), which
    then draws its render; all n variants in one batched render,
    tonemapped; (n, size, size, 3) on the device."""
    from fireflies_tpu_torch.render import RenderConfig, SceneBridge, render_rgb

    dev = device()
    bridge = SceneBridge(scene, **bridge_kwargs)
    randomize = scene.compile(device=dev)
    cfg = RenderConfig(width=size, height=size, spp=spp, max_bounces=bounces, tri_chunk=256)
    gens = [torch.Generator(device=dev).manual_seed(s) for s in step_seeds(seed, 0, n)]
    params = [dict(randomize(g, i), **(extra_params or {})) for i, g in enumerate(gens)]
    with torch.no_grad():
        return tonemap(render_rgb(bridge.assemble(params), gens, cfg))
