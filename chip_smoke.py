"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # 512x512, spp 1, 2 bounces, 16 variants

Phases (each raises on failure, so any failure exits non-zero):
  1. device: the card's name and power limit; CUDA must be available;
  2. build: compile the CUDA kernels of fireflies_tpu_torch/csrc from source;
  3. kernels: every kernel launch of one main-path forward batch (16
     randomized vocalfold variants at 512x512: camera rays, spot-light and
     projector shadow rays, bounce rays) recorded and replayed through the
     kernel and its plain PyTorch version, with times;
  4. reference: the CUDA path against the CPU path (plain versions, held
     against the JAX package by the tests) on a small deterministic render;
  5. forward: `render_batch` with the launch counters reset just before it,
     then renders/s (median of 5 timed batches);
  6. pattern step: loss and the (144, 3) beam gradient, seconds per step and
     peak device memory.
Then one JSON line with the kernels, the nvidia-smi line, and the result
line `{"ok": true, "device": {...}}` last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int) -> float:
    import torch  # noqa: PLC0415

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def compare(name, kernel_out, plain_out, any_hit: bool) -> dict:
    """Mismatch count and max |t| error of a kernel against its plain
    version.  Any-hit compares the blocked masks; closest hit allows a
    different prim only at a t-tie (1e-5 relative).  Wherever the prims
    agree, t must agree to 1e-5 relative (1e-6 absolute)."""
    import torch  # noqa: PLC0415

    (t_k, p_k), (t_p, p_p) = kernel_out, plain_out
    n_rays = p_p.numel()
    hit_diff = (p_k >= 0) != (p_p >= 0)
    if any_hit:
        bad = int(hit_diff.sum())
    else:
        tie = (t_k - t_p).abs() <= 1e-5 * t_p.abs().clamp(min=1.0)
        bad = int((hit_diff | ((p_k != p_p) & ~tie)).sum())
    same = (p_k == p_p) & (p_p >= 0)
    dt = (t_k - t_p).abs()[same]
    err = float(dt.max()) if dt.numel() else 0.0
    off_t = int((dt > 1e-6 + 1e-5 * t_p.abs()[same]).sum())
    n_hit = int((p_p >= 0).sum())
    log(f"  {name}: {bad} mismatched of {n_rays} rays ({n_hit} hit), max |dt| {err:.3g}, "
        f"{off_t} beyond 1e-5 relative")
    if any_hit and bad:
        raise AssertionError(f"{name}: any-hit masks differ on {bad} rays")
    if bad > 1e-4 * n_rays:
        raise AssertionError(f"{name}: {bad} mismatched rays exceed 1e-4 of {n_rays}")
    if off_t:
        raise AssertionError(f"{name}: t differs beyond 1e-5 relative on {off_t} rays")
    if not torch.isfinite(t_k).all():
        raise AssertionError(f"{name}: non-finite t")
    return {"mismatched": bad, "max_abs_err": err}


def kernel_phase(bridge, randomize, beams, cfg, seeds) -> dict:
    """Each kernel against its plain version on the inputs the main path
    gives it: one forward batch records every launch's inputs, and each is
    replayed through the kernel and the plain version.  Each closest-hit
    launch is replayed as any-hit too, since the scene casts no shadow
    where an emitter lights it and the main path's own any-hit launches
    find few or no blockers.  B1's times exclude building its tile lists, which
    are timed on their own (`lists_ms`)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import intersect_culled as ic  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import intersect_kernel as ik  # noqa: PLC0415

    versions = {"intersect_shared_culled": (ic.intersect_culled_packed,
                                            ic.intersect_culled_packed_plain),
                "intersect_general": (ik.intersect_packed, ik.intersect_packed_plain)}
    for k in KERNELS.values():
        k.recorded = []
    with torch.no_grad():
        main_path.render_batch(bridge, randomize, beams, seeds, cfg)
    torch.cuda.synchronize()
    results = {}
    for name, k in KERNELS.items():
        recorded, k.recorded = k.recorded, None
        if not recorded:
            raise AssertionError(f"{name}: the main path did not launch it")
        kernel_fn, plain_fn = versions[name]
        cases = []
        for i, rec in enumerate(recorded):
            cases.append((f"{name}/{'any' if rec['any_hit'] else 'closest'}#{i}", rec, False))
            if not rec["any_hit"]:
                cases.append((f"{name}/closest#{i}/as-any", {**rec, "any_hit": True}, True))
        for case, rec, replayed in cases:
            res = compare(case, kernel_fn(**rec), plain_fn(**rec), rec["any_hit"])
            res.update(kernel=name, any_hit=rec["any_hit"], replayed=replayed)
            res["ms"] = cuda_ms(lambda rec=rec: kernel_fn(**rec), 20)
            res["plain_ms"] = cuda_ms(lambda rec=rec: plain_fn(**rec), 2)
            line = f"  {case}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms"
            if "lists" in rec and not replayed:
                res["lists_ms"] = cuda_ms(lambda rec=rec: ic.tile_cluster_lists(
                    rec["dirs_soa"], rec["boxes"], t_min=rec["t_min"],
                    tmax_tiles=rec["tmax_tiles"]), 20)
                line += f", tile lists {res['lists_ms']:.4f} ms"
            log(line)
            results[case] = res
    return results


def reference_phase(bridge, randomize, beams, dev) -> None:
    """A small deterministic render (pixel-centre rays, one bounce) through
    the CUDA kernels against the same render through the plain versions on
    the CPU: within 1e-4 of the image max on >= 99.9% of pixels."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.projection import laser  # noqa: PLC0415
    from fireflies_tpu_torch.render import RenderConfig, pathtracer, rays  # noqa: PLC0415

    cfg = RenderConfig(width=128, height=32, spp=1, max_bounces=1, static_geometry=True)
    imgs = []
    for device in (dev, torch.device("cpu")):
        params = randomize(torch.Generator(device=dev).manual_seed(7), 0)
        params = {k: v.to(device) for k, v in params.items()}
        params.update(laser.rays_to_beam_params(
            beams.to(device), main_path.PROJECTOR_FOV, sigma=main_path.BEAM_SIGMA,
            texture_size=main_path.BEAM_TEXTURE))
        scene = bridge.assemble(params)
        o, d, _ = rays.camera_rays_tiled(scene.camera, cfg.width, cfg.height)
        with torch.no_grad():
            imgs.append(pathtracer.trace_rays(scene, o, d, None, cfg,
                                              primary_origin=scene.camera.to_world[:, :3, 3]))
    img_k, img_p = imgs[0].cpu(), imgs[1]
    bad = ((img_k - img_p).abs().amax(-1) > 1e-4 * img_p.abs().max()).float().mean().item()
    log(f"  CUDA vs CPU plain path (128x32, 1 bounce): {bad:.2e} of pixels beyond 1e-4 of max")
    if not (torch.isfinite(img_k).all() and img_p.max() > 0 and bad <= 1e-3):
        raise AssertionError("CUDA render disagrees with the plain-version render")


SIZE = 512
BATCH = 16


def main() -> int:
    import torch  # noqa: PLC0415

    # 1. device
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        return 1
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    from fireflies_tpu_torch import _build, main_path  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415

    # 2. build
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}"
        + (" (already built)" if cached else ""))
    report = _build.library_path().with_suffix(".log")
    for line in report.read_text().splitlines() if report.exists() else []:
        if "registers" in line or "Compiling entry" in line:
            log("  " + line.strip())

    bridge, randomize, beams = main_path.build(dev)
    cfg = main_path.bench_config(size=SIZE)
    seeds = list(range(BATCH))

    # 3. kernels against plain versions
    log("[kernels] main-path shapes: "
        f"{BATCH} variants x {SIZE}x{SIZE} rays, 1440 faces")
    kres = kernel_phase(bridge, randomize, beams, cfg, seeds)

    # 4. reference
    log("[reference]")
    reference_phase(bridge, randomize, beams, dev)

    # 5. forward main path, counted
    for k in KERNELS.values():
        k.launches = 0
    with torch.no_grad():
        img = main_path.render_batch(bridge, randomize, beams, seeds, cfg)
        torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"[forward] image {tuple(img.shape)} mean {img.mean().item():.6g} "
        f"max {img.max().item():.6g}; launches {launches}")
    if tuple(img.shape) != (BATCH, SIZE, SIZE, 3):
        raise AssertionError(f"unexpected image shape {tuple(img.shape)}")
    if not torch.isfinite(img).all() or img.abs().max() == 0:
        raise AssertionError("image is not finite or is all zero")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    times = []
    with torch.no_grad():
        main_path.render_batch(bridge, randomize, beams, seeds, cfg)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            main_path.render_batch(bridge, randomize, beams, seeds, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"[forward] {BATCH / med:.4f} renders/s (median batch {med:.4f} s; "
        f"batches {[round(t, 4) for t in times]})")

    # 6. pattern step, after a one-variant warm-up (the first backward in a
    # process loads the backward ops' kernels)
    main_path.pattern_step(bridge, randomize, beams, seeds[:1], cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grad = main_path.pattern_step(bridge, randomize, beams, seeds, cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[pattern_step] loss {loss.item():.6g} |grad| {grad.norm().item():.6g} "
        f"{step_s:.4f} s/step, peak {peak:.3f} GiB")
    if tuple(grad.shape) != (144, 3) or not torch.isfinite(grad).all() or grad.abs().max() == 0:
        raise AssertionError("beam gradient is not a finite nonzero (144, 3) tensor")

    sources = {
        "intersect_shared_culled": ("fireflies_tpu_torch/csrc/intersect_shared_culled.cu",
                                    "fireflies_tpu/render/pallas/intersect_culled.py:700"),
        "intersect_general": ("fireflies_tpu_torch/csrc/intersect_general.cu",
                              "fireflies_tpu/render/pallas/intersect_kernel.py:602"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in kres.values() if r["kernel"] == name]
        closest = next(r for r in mine if not r["any_hit"])
        # The main path's own any-hit launch where it has one (B1's shadow
        # rays), else a closest-hit launch replayed as any-hit (B3).
        any_hit = min((r for r in mine if r["any_hit"]), key=lambda r: r["replayed"])
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": closest["ms"], "plain_ms": closest["plain_ms"],
            "any_hit_ms": any_hit["ms"], "any_hit_plain_ms": any_hit["plain_ms"],
        }
        if "lists_ms" in closest:
            entry["tile_lists_ms"] = closest["lists_ms"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
