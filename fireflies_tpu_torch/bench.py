"""Pattern-optimization throughput: differentiable renders a second on one
GPU (port of bench.py::measure).

    python -m fireflies_tpu_torch.bench              # the headline row, one JSON line
    python -m fireflies_tpu_torch.bench --variants   # one line for each row of VARIANTS
    python -m fireflies_tpu_torch.bench --analytic 0 --resolution 75 ...   # one row
    python -m fireflies_tpu_torch.bench --multichip [--datagen]   # every visible card

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
`static_geom=0` and `smooth=1` take the differentiable face-table
attribute route (the latter with interpolated vertex normals).

`grad_mode="pose_soft"` is the counterpart of `bench.py::_measure_pose`: a
step is `main_path.pose_step`, the gradient with respect to a (3,) mesh
translation of the path-traced L2 plus a 256x256 soft-silhouette L2
against targets rendered once, untimed, over a fixed batch of variants;
windows chain delta = delta + 1e-20 * grad.  `grad_mode="pose_reparam"`
is the same step with `RenderConfig(reparam=True)`: the path-traced L2
alone, its silhouette and shadow-edge gradients from the warped-area pass
(render/reparam.py), whose warp the backward recomputes `reparam_chunk`
rays at a time.  `reparam_split=1` (`--reparam-split 1`, the counterpart of
BENCH_REPARAM_SPLIT) takes that step through
`render.reparam.reparam_split_value_and_grad` (the reference's phases,
which the port's monolithic step already runs as); the line's `pipeline`
says which entry ran.  The reference takes the
split at 384^2 and above because a monolithic 512^2 step outlived the TPU
runtime's limit on one dispatch; that threshold is the TPU's, not a
contract, so the port's default is the monolithic step at every size.

`measure_multichip` (`--multichip`) is the counterpart of
`bench.py::measure_multichip`, the reference's scale-out mode: the
headline step data-parallel over every visible card, each rank rendering
its own `batch_per_chip` variants from its own generators
(`parallel.shard_keys`) and `parallel.psum_grad_step` averaging the loss
and the beam gradient over the ranks; renders/s across the cards.
`--multichip --datagen` is `measure_datagen(multichip=True)`, the farm
spread over the cards (`datagen.generate_dataset_parallel`, rank 0
writing the frames): accepted frames/s in total and a card.  Called
outside a process group they start one rank a visible card themselves
(NCCL, rank r on card r; `world_size` ranks of gloo with
`--device cpu --world-size N`); called on every rank of a group already
started (`parallel.init_distributed`), they run as this rank.  A rank
that fails fails the command.

`measure_datagen` (`--datagen`, VARIANTS' `datagen=1` row) is the
counterpart of `bench.py::measure_datagen`: the dataset farm's accepted
frames/s, `datagen.generate_dataset` timed end to end after one untimed
warm-up dispatch (render, blur, clip, segmentation, a host readback every
dispatch, the rejection filter and the PNG writes), with peak device
memory and the dispatches' share of the time.  Its frames go to a
temporary directory, deleted after; the line carries the manifest (frame
count and one sha256 over the frames' own).

The measurement runs on the card unless the caller passes device="cpu"
(`--device cpu`), which the tests do at a tiny size; the result names its
device.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from fireflies_tpu_torch import datagen, main_path, parallel
from fireflies_tpu_torch.perf_probe import nvidia_smi
from fireflies_tpu_torch.render import RenderConfig


def step_seeds(trial: int, i: int, batch: int) -> list[int]:
    """The variant seeds of step i of a trial, distinct for every (trial, i,
    variant); trial -1 is the warm-up (the reference folds trial * 1000 + i
    into its key and splits it over the batch)."""
    return [((trial + 1) * 1000 + i) * batch + j for j in range(batch)]


POSE_VARIANT_SEED = 10**6  # the fixed variants of a pose measurement: seeds from here
POSE_TARGET_SEED = 2 * 10**6  # the draws of its targets' renders


def _windows(step, x0: torch.Tensor, repeats: int, trials: int) -> list[float]:
    """After one untimed warm-up step, `trials` windows of `repeats` steps,
    each chained x = step(x, trial, i) from x0 and ended by a host readback
    of x, which must be finite; the windows' wall seconds."""
    float(step(x0, -1, 0).sum())  # warm-up, waited for
    trial_dts = []
    for trial in range(trials):
        t0 = time.perf_counter()
        x = x0
        for i in range(repeats):
            x = step(x, trial, i)
        checksum = float(x.sum())  # the host readback ends the window
        dt = time.perf_counter() - t0
        if not math.isfinite(checksum):
            raise FloatingPointError(f"trial {trial}: the chained step input is not finite")
        trial_dts.append(dt)
    return trial_dts


def measure(size: int = 512, spp: int = 1, bounces: int = 2, repeats: int = 20,
            resolution: int = 24, batch: int = 16, trials: int = 3, analytic: int = 1,
            coherent: int = 0, shared: int = 0, tile_cull: int = 1, static_geom: int = 1,
            smooth: int = 0, ray_chunk: int = 0, grad_mode: str = "beams",
            soft_size: int = main_path.SOFT_SIZE, reparam_chunk: int = 2048,
            reparam_split: int = 0, device="cuda") -> dict:
    """One throughput measurement of the pattern-optimization step
    (`grad_mode="beams"`) or of the pose step (the gradient with respect to
    a mesh translation, on the face-table route, with the analytic
    projector: `"pose_soft"`, the path-traced L2 plus a soft_size x
    soft_size soft-silhouette L2; `"pose_reparam"`, the path-traced L2 with
    warped-area gradients, the warp recomputed `reparam_chunk` rays at a
    time, with `reparam_split` through `reparam_split_value_and_grad`); the
    result line as a dict (metric, value, unit, detail)."""
    if grad_mode not in ("beams", "pose_soft", "pose_reparam"):
        raise ValueError(f"grad_mode={grad_mode!r}: beams, pose_soft or pose_reparam")
    pose = grad_mode != "beams"
    reparam = grad_mode == "pose_reparam"
    if reparam_split and not reparam:
        raise ValueError("reparam_split needs grad_mode='pose_reparam'")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to measure on the CPU")
    bridge, randomize, rays0 = main_path.build(dev, resolution=resolution, smooth=bool(smooth))
    cfg = main_path.bench_config(size=size, spp=spp, bounces=bounces,
                                 coherent_bounce=bool(coherent), shared_primary=bool(shared),
                                 tile_cull=bool(tile_cull),
                                 static_geometry=bool(static_geom) and not pose)
    cfg = cfg.replace(ray_chunk=ray_chunk)
    if reparam:
        cfg = cfg.replace(reparam=True, reparam_chunk=reparam_chunk)
    n_faces = len(bridge._faces)
    analytic = analytic or pose
    losses = []

    if pose:
        seeds = [POSE_VARIANT_SEED + j for j in range(batch)]
        targets = main_path.pose_targets(bridge, randomize, rays0, seeds, cfg,
                                         [POSE_TARGET_SEED + j for j in range(batch)], soft_size)

        def step(delta, trial: int, i: int):
            loss, grad = main_path.pose_step(bridge, randomize, rays0, delta, seeds, targets, cfg,
                                             soft_size, render_seeds=step_seeds(trial, i, batch),
                                             split=bool(reparam_split))
            losses.append(loss)
            return delta + 1e-20 * grad

        x0 = torch.zeros(3, device=dev)
    else:
        def step(rays, trial: int, i: int):
            _, grad = main_path.pattern_step(bridge, randomize, rays,
                                             step_seeds(trial, i, batch), cfg,
                                             analytic=bool(analytic))
            return rays + 1e-20 * grad

        x0 = rays0

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    trial_dts = _windows(step, x0, repeats, trials)
    dt = min(trial_dts)
    per_trial = sorted(repeats * batch / t for t in trial_dts)
    detail = {
        "faces": n_faces, "spp": spp, "bounces": bounces, "batch": batch,
        "repeats": repeats, "size": size,
        "route": "analytic-beam-splat" if analytic else "texture",
        "static_geometry": cfg.static_geometry,
        "shared_primary": cfg.shared_primary,
        "tile_cull": cfg.tile_cull,
        "smooth": bool(smooth),
        "ray_chunk": cfg.ray_chunk,
        "grad_mode": grad_mode,
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
    }
    if reparam:
        detail.update(reparam_chunk=reparam_chunk, reparam_k_aux=cfg.reparam_k_aux,
                      pipeline="split" if reparam_split else "monolithic",
                      loss=float(losses[-1]))
    elif pose:
        detail.update(soft_size=soft_size, loss=float(losses[-1]))
    return {
        "metric": (
            f"{size}x{size} diff-renders/sec/chip "
            f"(vocalfold {n_faces} faces, spp={spp}, bounces={bounces}"
            + (", smooth" if smooth else "")
            + (", coherent-bounce" if cfg.coherent_bounce else "")
            + (", static-geometry" if cfg.static_geometry else ", diff-attrs")
            + (", shared-primary" if cfg.shared_primary and spp > 1 and not ray_chunk else "")
            + (f", ray-chunk {ray_chunk}" if ray_chunk else "")
            + ("" if cfg.tile_cull else ", no-tile-cull")
            + (f", pose-grad soft mask{soft_size}" if pose and not reparam else "")
            + (f", pose-grad reparam chunk{reparam_chunk}" if reparam else "")
            + (", split" if reparam_split else "")
            + (", analytic-projector" if analytic else "") + ")"
        ),
        "value": round(repeats * batch / dt, 3),
        "unit": "renders/sec/chip",
        "detail": detail,
    }


def _image_mean(img: torch.Tensor, aux: dict) -> torch.Tensor:
    """Each variant's mean image (the headline step's loss, per variant)."""
    return img.mean(dim=(1, 2, 3))


def multichip_seed(trial: int, i: int) -> int:
    """The seed of step i of a trial of `measure_multichip` (trial -1 is the
    warm-up): every rank takes its generators of that step from it
    (`parallel.shard_keys`), so the ranks' variants are distinct and the
    whole step's are those of one process's step over
    `utils.seeds.step_seeds(seed, 0, chips * batch_per_chip)`."""
    return (trial + 1) * 1000 + i


def _rank_main(rank: int, world_size: int, device_type: str, store_dir: str, threads: int,
               target, kwargs: dict) -> None:
    """One rank of `_run_ranks`: its group started through the FileStore in
    store_dir (NCCL on card `rank`, gloo on the CPU), target(**kwargs,
    device=its device) run, rank 0's result saved beside the store."""
    torch.set_num_threads(threads)
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    parallel.init_distributed(rank, world_size, dev, store_path=os.path.join(store_dir, "store"))
    try:
        out = target(**kwargs, device=dev)
        if rank == 0:
            torch.save(out, os.path.join(store_dir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def _run_ranks(target, world_size: int, device_type: str, kwargs: dict):
    """target(**kwargs, device=...) on world_size new processes, one rank
    each, sharing this process's torch threads (at least one a rank); rank
    0's result.  A rank that raises or dies ends the others and raises
    here."""
    import torch.multiprocessing as mp  # noqa: PLC0415

    if device_type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards, "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(world_size, device_type, tmp,
                                             max(1, torch.get_num_threads() // world_size),
                                             target, kwargs),
                           nprocs=world_size, join=True, start_method="spawn")
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)


def _world(world_size: int | None, dev: torch.device) -> int | None:
    """None when this process is a rank of a started group (the caller runs
    as it), else the number of ranks to start: `world_size`, by default
    every visible card (one on the CPU)."""
    if dist.is_initialized():
        if world_size not in (None, dist.get_world_size()):
            raise ValueError(f"world_size={world_size} in a group of {dist.get_world_size()}")
        return None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to measure on the CPU")
    return world_size or (torch.cuda.device_count() if dev.type == "cuda" else 1)


def measure_multichip(size: int = 512, spp: int = 1, bounces: int = 2, repeats: int = 10,
                      resolution: int = 24, batch_per_chip: int = 16, trials: int = 3,
                      world_size: int | None = None, first_step: bool = False,
                      device="cuda") -> dict:
    """The headline pattern step data-parallel over `world_size` ranks (by
    default every visible card): each rank renders its own batch_per_chip
    variants from its own generators (`parallel.shard_keys` of
    `multichip_seed`), and `parallel.psum_grad_step` averages the loss
    (each variant's mean image, `main_path.variant_loss`) and the beam
    gradient over the ranks.  After one untimed warm-up step, `trials`
    windows of `repeats` steps chained by rays + 1e-20 * grad, each ended by
    a finite host readback; a window lasts as long as its slowest rank.
    renders/s = repeats * batch_per_chip * ranks / the best window; the
    result line (rank 0's) as a dict.  `first_step` adds the warm-up step's
    seed, loss and gradient, for checks."""
    dev = torch.device(device)
    world = _world(world_size, dev)
    kwargs = dict(size=size, spp=spp, bounces=bounces, repeats=repeats, resolution=resolution,
                  batch_per_chip=batch_per_chip, trials=trials, first_step=first_step)
    if world is not None:
        return _run_ranks(measure_multichip, world, dev.type, kwargs)
    on_card = dev.type == "cuda"
    mesh = parallel.make_mesh(device=dev)
    chips = mesh.size
    bridge, randomize, rays0 = main_path.build(dev, resolution=resolution)
    cfg = main_path.bench_config(size=size, spp=spp, bounces=bounces)
    n_faces = len(bridge._faces)
    loss_fn = main_path.variant_loss(bridge, randomize, cfg, _image_mean)
    psum = parallel.psum_grad_step(lambda rays, gens: loss_fn(rays, gens, 0), mesh)
    first = {}

    def step(rays, trial: int, i: int):
        seed = multichip_seed(trial, i)
        loss, grad = psum(rays, parallel.shard_keys(mesh, seed, batch_per_chip))
        if trial == -1:
            first.update(seed=seed, loss=float(loss), grad=grad.cpu().tolist())
        return rays + 1e-20 * grad

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    trial_dts = _windows(step, rays0, repeats, trials)
    if chips > 1:
        slowest = torch.tensor(trial_dts, dtype=torch.float64, device=dev)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        trial_dts = slowest.tolist()
    dt = min(trial_dts)
    total = repeats * batch_per_chip * chips / dt
    per_trial = sorted(repeats * batch_per_chip * chips / t for t in trial_dts)
    detail = {
        "chips": chips, "per_chip": round(total / chips, 3), "faces": n_faces, "spp": spp,
        "bounces": bounces, "batch_per_chip": batch_per_chip, "repeats": repeats, "size": size,
        "route": "analytic-beam-splat", "backend": dist.get_backend(),
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
    }
    if first_step:
        detail["first_step"] = first
    return {
        "metric": (f"{size}x{size} diff-renders/sec across {chips} "
                   f"{'card' if on_card else 'CPU rank'}(s) (vocalfold {n_faces} faces, "
                   f"spp={spp}, variant-DP psum, analytic-projector)"),
        "value": round(total, 3),
        "unit": "renders/sec",
        "detail": detail,
    }


DATAGEN_SEED = 0  # generate_dataset's seed
DATAGEN_WARMUP_SEED = 99  # the warm-up dispatch's frame seeds: from here


def measure_datagen(size: int = 512, spp: int = 4, resolution: int = 24, batch: int = 8,
                    n_frames: int = 32, multichip: bool = False, world_size: int | None = None,
                    device="cuda") -> dict:
    """Dataset-farm throughput at the reference's shape (512^2, spp 4,
    vocalfold 1440 faces, batch 8, 32 accepted frames, RenderConfig's
    default face-table route, the analytic projector): accepted frames a
    second of `datagen.generate_dataset` over `main_path.datagen_batch`,
    after one untimed warm-up dispatch; the result line as a dict.

    With `multichip` the farm runs over `world_size` ranks (by default
    every visible card): `datagen.generate_dataset_parallel` with `batch`
    frames a rank a dispatch, the ranks' frames gathered and rank 0
    filtering and writing them; the line gives frames/s a rank and in total
    (`frames_per_sec_total`), rank 0's."""
    dev = torch.device(device)
    if multichip:
        world = _world(world_size, dev)
        if world is not None:
            return _run_ranks(measure_datagen, world, dev.type,
                              dict(size=size, spp=spp, resolution=resolution, batch=batch,
                                   n_frames=n_frames, multichip=True))
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to measure on the CPU")
    mesh = parallel.make_mesh(device=dev) if multichip else None
    chips = mesh.size if multichip else 1
    bridge, randomize, rays0 = main_path.build(dev, resolution=resolution)
    cfg = RenderConfig(width=size, height=size, spp=spp, max_bounces=2)
    n_faces = len(bridge._faces)
    farm_batch = main_path.datagen_batch(bridge, randomize, rays0, cfg)
    render_s = []

    def render_batch(seeds, steps):
        """A dispatch read back to the host (left on the device for the
        ranks' gather, and waited for), its wall time kept."""
        t0 = time.perf_counter()
        out = farm_batch(seeds, steps)
        if not multichip:
            out = tuple(x.cpu() for x in out)
        elif on_card:
            torch.cuda.synchronize(dev)
        render_s.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as td:
        render_batch(list(range(DATAGEN_WARMUP_SEED, DATAGEN_WARMUP_SEED + batch)),
                     list(range(batch)))  # warm-up, untimed
        if multichip:  # the farm's collective once, so NCCL starts its communicator untimed
            dist.broadcast(torch.zeros(1, dtype=torch.int64, device=dev), src=0)
        render_s.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if multichip:
            got = datagen.generate_dataset_parallel(render_batch, n_frames, td, DATAGEN_SEED,
                                                    mesh, per_device=batch)
        else:
            got = datagen.generate_dataset(render_batch, n_frames=n_frames, out_dir=td,
                                           seed=DATAGEN_SEED, batch=batch)
        dt = time.perf_counter() - t0
        frames = sorted((Path(td) / "images").glob("*.png"))
        hashes = [hashlib.sha256(f.read_bytes()).hexdigest()[:16] for f in frames]
    fps = got / dt
    detail = {
        "faces": n_faces, "spp": spp, "batch": batch, "size": size,
        "frames_accepted": got, "seconds": round(dt, 3), "dispatches": len(render_s),
        # the dispatches' render and readback; the rest is the host's
        # rejection filter and PNG writes
        "render_seconds": round(sum(render_s), 3),
        "route": "analytic-beam-splat", "static_geometry": cfg.static_geometry,
        "manifest": {"n_frames": got,
                     "sha256": hashlib.sha256("".join(hashes).encode()).hexdigest()},
        "peak_device_memory_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
                                   if on_card else None),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": nvidia_smi() if on_card else None,
    }
    if multichip:
        detail.update(chips=chips, frames_per_sec_total=round(fps, 3), backend=dist.get_backend())
    return {
        "metric": (f"{size}x{size} dataset-farm frames/sec/chip (vocalfold {n_faces} faces, "
                   f"spp={spp}, render+seg+postproc+rejection+png, analytic-projector"
                   + (f", across {chips} rank(s)" if multichip else "") + ")"),
        "value": round(fps / chips, 3),
        "unit": "frames/sec/chip",
        "detail": detail,
    }


# bench.py's VARIANTS (bench.py:637-692), in its keys, which are measure's
# arguments; `datagen=1` is measure_datagen at its defaults.
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


def run_variants(device="cuda") -> int:
    """One JSON line for each row of VARIANTS: its measurement or, for a
    row whose step does not fit in device memory, the error.  Returns the
    number of rows that ran out of memory."""
    failed = 0
    for index, row in enumerate(VARIANTS):
        line = {"variant": index, "row": row}
        try:
            if row.get("datagen", 0):
                line.update(measure_datagen(device=device))
            else:
                line.update(measure(**row, device=device))
        except torch.cuda.OutOfMemoryError as exc:
            failed += 1
            line["error"] = f"out of device memory: {str(exc).splitlines()[0]}"
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return failed


# The options of `measure` that --multichip and --datagen take, by the
# names of their own arguments.
MULTICHIP_OPTIONS = {"size": "size", "spp": "spp", "bounces": "bounces", "repeats": "repeats",
                     "resolution": "resolution", "trials": "trials", "batch": "batch_per_chip"}
DATAGEN_OPTIONS = {"size": "size", "spp": "spp", "resolution": "resolution", "batch": "batch"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true",
                    help="one line for each row of VARIANTS (the row options are ignored)")
    ap.add_argument("--datagen", action="store_true",
                    help="the dataset-farm row, at its defaults unless "
                         f"{', '.join('--' + k for k in DATAGEN_OPTIONS)} say otherwise")
    ap.add_argument("--multichip", action="store_true",
                    help="the headline step over every visible card, at its defaults unless "
                         f"{', '.join('--' + k for k in MULTICHIP_OPTIONS)} say otherwise "
                         "(with --datagen: the farm)")
    ap.add_argument("--world-size", type=int, default=None,
                    help="--multichip's ranks (default: every visible card; 1 on the CPU)")
    ap.add_argument("--device", default="cuda")
    for name, p in inspect.signature(measure).parameters.items():
        if name != "device":
            ap.add_argument("--" + name.replace("_", "-"), dest=name, type=type(p.default),
                            default=argparse.SUPPRESS,
                            help=f"default {p.default}")
    args = vars(ap.parse_args(argv))
    device, world_size = args.pop("device"), args.pop("world_size")
    if args.pop("variants"):
        return 1 if run_variants(device) else 0
    multichip, farm = args.pop("multichip"), args.pop("datagen")
    if multichip or farm:
        options = DATAGEN_OPTIONS if farm else MULTICHIP_OPTIONS
        other = sorted(set(args) - set(options))
        if other:
            ap.error(f"{'--datagen' if farm else '--multichip'} does not take {other}")
        kwargs = {options[k]: v for k, v in args.items()}
        if not multichip:
            line = measure_datagen(**kwargs, device=device)
        elif farm:
            line = measure_datagen(**kwargs, multichip=True, world_size=world_size, device=device)
        else:
            line = measure_multichip(**kwargs, world_size=world_size, device=device)
        print(json.dumps(line), flush=True)
        return 0
    print(json.dumps(measure(**args, device=device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
