"""Pattern-optimization throughput: differentiable renders a second on one
GPU (port of bench.py::measure).

    python -m fireflies_tpu_torch.bench              # the headline row, one JSON line
    python -m fireflies_tpu_torch.bench --variants   # one line for each row of VARIANTS
    python -m fireflies_tpu_torch.bench --analytic 0 --resolution 75 ...   # one row

A differentiable render is one randomized vocalfold variant's forward
render plus its share of the gradient of the image loss with respect to the
(144, 3) laser beam directions.  A step is `main_path.pattern_step` over a
batch of variants: one batched render, the loss (the mean over variants of
the mean image) and one backward.  After one untimed warm-up step, each of
`trials` windows runs `repeats` steps chained by rays = rays + 1e-20 * grad
and ends with a host readback of the rays, which must be finite; the best
window is the headline, the spread of all windows stands beside it.

Two projector routes: the analytic beam splat (`analytic=1`, the headline)
and the texture route (`analytic=0`), whose beams are rasterized once a
step into a 256x256 texture that every variant's projector looks up.

The measurement runs on the card unless the caller passes device="cpu"
(`--device cpu`), which the tests do at a tiny size; the result names its
device.  Rows of VARIANTS that the port cannot run yet print a line naming
the refusal.  Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import statistics
import sys
import time

import torch

from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.perf_probe import nvidia_smi


def step_seeds(trial: int, i: int, batch: int) -> list[int]:
    """The variant seeds of step i of a trial, distinct for every (trial, i,
    variant); trial -1 is the warm-up (the reference folds trial * 1000 + i
    into its key and splits it over the batch)."""
    return [((trial + 1) * 1000 + i) * batch + j for j in range(batch)]


def measure(size: int = 512, spp: int = 1, bounces: int = 2, repeats: int = 20,
            resolution: int = 24, batch: int = 16, trials: int = 3, analytic: int = 1,
            coherent: int = 0, shared: int = 0, tile_cull: int = 1,
            device="cuda") -> dict:
    """One throughput measurement of the pattern-optimization step; the
    result line as a dict (metric, value, unit, detail)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to measure on the CPU")
    bridge, randomize, rays0 = main_path.build(dev, resolution=resolution)
    cfg = main_path.bench_config(size=size, spp=spp, bounces=bounces,
                                 coherent_bounce=bool(coherent), shared_primary=bool(shared),
                                 tile_cull=bool(tile_cull))
    n_faces = len(bridge._faces)

    def step(rays, trial: int, i: int):
        _, grad = main_path.pattern_step(bridge, randomize, rays, step_seeds(trial, i, batch),
                                         cfg, analytic=bool(analytic))
        return rays + 1e-20 * grad

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    float(step(rays0, -1, 0).sum())  # warm-up, waited for
    trial_dts = []
    for trial in range(trials):
        t0 = time.perf_counter()
        rays = rays0
        for i in range(repeats):
            rays = step(rays, trial, i)
        checksum = float(rays.sum())  # the host readback ends the window
        dt = time.perf_counter() - t0
        if not math.isfinite(checksum):
            raise FloatingPointError(f"trial {trial}: the chained beam directions are not finite")
        trial_dts.append(dt)
    dt = min(trial_dts)
    per_trial = sorted(repeats * batch / t for t in trial_dts)
    return {
        "metric": (
            f"{size}x{size} diff-renders/sec/chip "
            f"(vocalfold {n_faces} faces, spp={spp}, bounces={bounces}"
            + (", coherent-bounce" if cfg.coherent_bounce else "")
            + ", static-geometry"
            + (", shared-primary" if cfg.shared_primary and spp > 1 else "")
            + ("" if cfg.tile_cull else ", no-tile-cull")
            + (", analytic-projector" if analytic else "") + ")"
        ),
        "value": round(repeats * batch / dt, 3),
        "unit": "renders/sec/chip",
        "detail": {
            "faces": n_faces, "spp": spp, "bounces": bounces, "batch": batch,
            "repeats": repeats, "size": size,
            "route": "analytic-beam-splat" if analytic else "texture",
            "static_geometry": cfg.static_geometry,
            "shared_primary": cfg.shared_primary,
            "tile_cull": cfg.tile_cull,
            "optim_iters_per_sec": round(repeats / dt, 3),
            "renders_per_sec_dispersion": {
                "min": round(per_trial[0], 3),
                "median": round(statistics.median(per_trial), 3),
                "max": round(per_trial[-1], 3),
                "trials": len(per_trial),
            },
            "peak_device_memory_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
                                       if on_card else None),
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "card": nvidia_smi() if on_card else None,
        },
    }


# bench.py's VARIANTS (bench.py:637-692), in its keys, which are measure's
# arguments but for the refused ones below.
VARIANTS = [
    dict(),
    dict(analytic=0),
    dict(spp=4, repeats=10),
    dict(spp=16, repeats=4),
    dict(analytic=0, spp=4, repeats=10),
    dict(analytic=0, spp=16, repeats=4),
    dict(resolution=75, repeats=10),
    dict(resolution=75, spp=4, repeats=5),
    dict(resolution=75, spp=4, repeats=5, coherent=1),
    dict(resolution=75, spp=4, repeats=5, coherent=1, static_geom=0),
    dict(resolution=75, spp=4, repeats=5, coherent=1, shared=1),
    dict(resolution=75, spp=16, repeats=3, coherent=1, shared=1),
    dict(resolution=75, spp=16, repeats=3, coherent=1),
    dict(analytic=0, resolution=75, repeats=10),
    dict(analytic=0, resolution=75, spp=4, repeats=5),
    dict(resolution=160, repeats=5),
    dict(analytic=0, resolution=160, repeats=5),
    dict(smooth=1),
    dict(grad_mode="pose_soft", repeats=10),
    dict(grad_mode="pose_reparam", repeats=1, batch=2, size=256, reparam_chunk=1024, trials=2),
    dict(grad_mode="pose_reparam", repeats=1, batch=2, size=512, reparam_chunk=8192, trials=2),
    dict(datagen=1),
]


def refusal(row: dict) -> str | None:
    """Why the port cannot run a VARIANTS row yet, or None."""
    if row.get("static_geom", 1) == 0:
        return "static_geometry=False (the differentiable face-table attribute route) is not ported"
    if row.get("smooth", 0):
        return "smooth vertex normals are not ported"
    if row.get("grad_mode", "beams") != "beams":
        return (f"grad_mode={row['grad_mode']} (geometry gradients: static_geometry=False, "
                "soft silhouettes, reparameterization) is not ported")
    if row.get("datagen", 0):
        return "the dataset farm (datagen) is not ported"
    return None


def run_variants(device="cuda") -> int:
    """One JSON line for each row of VARIANTS: its measurement, its refusal,
    or, for a row whose step does not fit in device memory, the error.
    Returns the number of rows that ran out of memory."""
    failed = 0
    for index, row in enumerate(VARIANTS):
        why = refusal(row)
        line = {"variant": index, "row": row}
        if why is not None:
            line["refused"] = why
        else:
            try:
                line.update(measure(**row, device=device))
            except torch.cuda.OutOfMemoryError as exc:
                failed += 1
                line["error"] = f"out of device memory: {str(exc).splitlines()[0]}"
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true",
                    help="one line for each row of VARIANTS (the row options are ignored)")
    ap.add_argument("--device", default="cuda")
    for name, p in inspect.signature(measure).parameters.items():
        if name != "device":
            ap.add_argument("--" + name.replace("_", "-"), dest=name, type=int, default=p.default)
    args = vars(ap.parse_args(argv))
    if args.pop("variants"):
        return 1 if run_variants(args["device"]) else 0
    print(json.dumps(measure(**args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
