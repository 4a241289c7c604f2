"""Drive the PyTorch/CUDA port's render paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Five paths, each a batch of 16 randomized vocalfold variants at 512x512
with 2 bounces through `main_path.render_batch` / `pattern_step`
(`main_path.SHAPES`):
  * main: 1440 faces, spp 1 (the reference benchmark's default; kernels B1
    for camera and shadow rays, B3 for bounce rays);
  * reference shape: 11538 faces, spp 4, coherent bounce, shared primary
    (B2 for camera and shadow rays, B4 for bounce rays, with kernel-emitted
    hit attributes);
  * mid-sized: 5288 faces, spp 1 (B1, and B5 for bounce rays);
  * main_unculled and reference_unculled: main and the reference shape with
    tile culling off (`RenderConfig.tile_cull=False`, the reference's
    FF_NO_TILE_CULL=1): B6 and B3; B7s and B7g with the attribute gather.
Then X1, the reference's parked matrix-unit intersection, through its own
entry point on the camera rays of the main and reference shapes, and the
probe's FP32 throughput kernel X2 and kernel roof.

Phases (each raises on failure, so any failure exits non-zero):
  1. device: the card's name and power limit; CUDA must be available;
  2. build: compile the CUDA kernels of fireflies_tpu_torch/csrc from
     source, one nvcc per source, all started together;
  then for each path:
  3. kernels: the kernel launches of one forward batch recorded and
     replayed through the kernel and its plain PyTorch version, with times
     and each launch's bound (from the pairs the kernel reports it tested).
     On the main path every launch is replayed;
     on the other paths only the first launch of each (kernel, mode), and
     the plain version runs on the first 2 of the 16 variants (the kernel's
     output for those variants is compared; the plain versions are slow at
     11.5k faces);
  4. reference (main path): the CUDA path against the CPU path (plain
     versions, held against the JAX package by the tests) on a small
     deterministic render;
  5. forward: `render_batch` with every launch counter set to 0 just before
     it and read just after: the path's kernels must have launched and no
     other; then renders/s (median of 5 timed batches);
  6. pattern step (main, reference and reference_unculled): loss and the
     (144, 3) beam gradient, seconds per step and peak device memory;
  7. probe: X2 (`perf_probe.vpu_roof`, its counter set to 0 just before and
     read just after) bit for bit against its plain version, its time,
     bound and rate of unfused FP32 operations; the kernel roof (B3 on a
     workload where every pair is tested);
  8. mxu: X1 (`experiments.intersect_mxu.intersect_mxu_shared`, its counter
     set to 0 just before and read just after) on 16 variants' camera rays
     at 512x512 from the main and reference shapes, with t_max = 1e30 and
     with a per-ray t_max that cuts about half the hits; each launch
     replayed through the kernel and its plain version (2 variants),
     closest and as any-hit, which must agree exactly; X1's prims against
     B6's on the same rays; times and bound.
Then one JSON line with the kernels (each with its fused operations per
tested pair, `ops_per_pair`; for X2 its unfused operations per element and
round; the script fails if a kernel ran faster than its bound), the
nvidia-smi line, and the result line `{"ok": true, "device": {...}}` last.
"""

from __future__ import annotations

import json
import statistics
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, kernel_out, plain_out, any_hit: bool) -> dict:
    """Mismatch count and max |t| error of a kernel against its plain
    version.  Any-hit compares the blocked masks; closest hit allows a
    different prim only at a t-tie (1e-5 relative), on at most 1e-4 of the
    rays.  Wherever the prims agree, t must agree to 1e-5 relative (1e-6
    absolute) and emitted normals and material ids must be equal."""
    import torch  # noqa: PLC0415

    (t_k, p_k, *attrs_k), (t_p, p_p, *attrs_p) = kernel_out, plain_out
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
    if len(attrs_k) != len(attrs_p):
        raise AssertionError(f"{name}: {len(attrs_k)} attribute outputs against {len(attrs_p)}")
    off_attr = sum(int((a_k != a_p)[same].sum()) for a_k, a_p in zip(attrs_k, attrs_p))
    log(f"  {name}: {bad} mismatched of {n_rays} rays ({n_hit} hit), max |dt| {err:.3g}, "
        f"{off_t} beyond 1e-5 relative" + (f", {off_attr} attribute values differ"
                                           if attrs_k else ""))
    if any_hit and bad:
        raise AssertionError(f"{name}: any-hit masks differ on {bad} rays")
    if bad > 1e-4 * n_rays:
        raise AssertionError(f"{name}: {bad} mismatched rays exceed 1e-4 of {n_rays}")
    if off_t:
        raise AssertionError(f"{name}: t differs beyond 1e-5 relative on {off_t} rays")
    if off_attr:
        raise AssertionError(f"{name}: emitted attributes differ on {off_attr} values")
    if not torch.isfinite(t_k).all():
        raise AssertionError(f"{name}: non-finite t")
    return {"mismatched": bad, "max_abs_err": err}


def bound(name: str, rec: dict, n_out: int, tested) -> dict:
    """The least time the card could take for one launch: the larger of
    its bytes (every input tensor read once, `n_out` 4-byte outputs per
    ray written once) over the memory rate, and its operations over the
    rate of FP32 operations with a fused multiply-add as one
    (`perf_probe.PEAK_*`).  The operations are the pairs the kernel tested
    on this launch's data (`tested`: per live ray, the clusters its faces
    were tested against after the slab test, its block's vote or, in B4 and
    B7g, its own) x the faces of a cluster x
    `perf_probe.OPS_PER_PAIR`, the fused count of its pair test; the
    per-cluster slab tests are left out.
    Also the pairs on the tile lists (every cluster without lists), which
    the kernel tests at most."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch.perf_probe import (  # noqa: PLC0415
        OPS_PER_PAIR,
        PEAK_BYTES,
        PEAK_FP32_OPS,
    )
    from fireflies_tpu_torch.render.cuda.intersect_kernel import RAY_TILE  # noqa: PLC0415

    tensors = [v for v in rec.values() if isinstance(v, torch.Tensor)]
    tmax = rec["tmax_tiles"]
    b = tmax.shape[0]
    n_rays = tmax[0].numel()
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + n_out * 4 * b * n_rays
    table = rec.get("woop16", rec.get("woop", rec.get("tri")))
    nc = rec["boxes"].shape[2]
    faces_per_cluster = table.shape[2] // nc
    if "counts" in rec:
        listed = rec["counts"].expand(b, n_rays // RAY_TILE, RAY_TILE).reshape(tmax.shape)
    else:
        listed = torch.full_like(tested, nc)
    listed = torch.where(tmax >= 0, listed, 0)
    over = int((tested > listed).sum())
    if over:
        raise AssertionError(f"{name}: {over} rays report more tested clusters than listed")
    pairs = float(tested.double().sum()) * faces_per_cluster
    ops = pairs * OPS_PER_PAIR[name]
    mem_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms > ops_ms else "operations",
            "pairs": pairs, "listed_pairs": float(listed.double().sum()) * faces_per_cluster,
            "bytes": nbytes}


def versions():
    from fireflies_tpu_torch.render.cuda import intersect_culled as ic  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import intersect_general_culled as igc  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import intersect_kernel as ik  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import intersect_stream as ist  # noqa: PLC0415

    def shared_lists(rec):
        rays = rec["rays_soa"] if "rays_soa" in rec else rec["dirs_soa"]
        return ic.tile_cluster_lists(rays, rec["boxes"], t_min=rec["t_min"],
                                     tmax_tiles=rec["tmax_tiles"])

    def general_lists(rec):
        return ic.tile_cluster_lists_general(rec["rays_soa"], rec["boxes"], t_min=rec["t_min"],
                                             tmax_tiles=rec["tmax_tiles"])

    # name: (kernel wrapper, plain version, tile-list builder or None)
    return {
        "intersect_shared": (ik.intersect_shared_packed, ik.intersect_shared_packed_plain, None),
        "intersect_stream": (ist.intersect_stream_packed, ist.stream_packed_plain, None),
        "intersect_stream_general": (ist.intersect_stream_general_packed, ist.stream_packed_plain,
                                     None),
        "intersect_shared_culled": (ic.intersect_culled_packed, ic.intersect_culled_packed_plain,
                                    shared_lists),
        "intersect_general": (ik.intersect_packed, ik.intersect_packed_plain, None),
        "intersect_stream_culled": (ist.intersect_stream_culled_packed,
                                    ist.stream_culled_packed_plain, shared_lists),
        "intersect_stream_general_culled": (ist.intersect_stream_general_culled_packed,
                                            ist.stream_culled_packed_plain, general_lists),
        "intersect_general_culled": (igc.intersect_general_culled_packed,
                                     igc.intersect_general_culled_packed_plain, general_lists),
    }


def _first(rec: dict, n: int) -> dict:
    """The recorded inputs of the first n variants."""
    import torch  # noqa: PLC0415

    return {k: v[:n].contiguous() if isinstance(v, torch.Tensor) else v for k, v in rec.items()}


def kernel_phase(path: str, drive, first_only: bool, plain_variants: int | None) -> dict:
    """Each kernel against its plain version on the inputs a path gives it:
    one forward batch records every launch's inputs, and each (or, with
    `first_only`, the first of each kernel and mode) is replayed through
    the kernel and the plain version, the latter on the first
    `plain_variants` variants when given.  Each closest-hit launch is
    replayed as any-hit too, since the scene casts no shadow where an
    emitter lights it and a path's own any-hit launches find few or no
    blockers.  Kernel times exclude building the tile lists, which are
    timed on their own (`lists_ms`)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch.perf_probe import cuda_ms  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415

    table = versions()
    for k in KERNELS.values():
        k.recorded = []
    with torch.no_grad():
        drive()
    torch.cuda.synchronize()
    results = {}
    for name, k in KERNELS.items():
        recorded, k.recorded = k.recorded, None
        if not recorded:
            continue
        kernel_fn, plain_fn, lists_fn = table[name]
        cases, seen = [], set()
        for i, rec in enumerate(recorded):
            mode = "any" if rec["any_hit"] else "closest"
            if first_only and mode in seen:
                continue
            seen.add(mode)
            cases.append((f"{path}/{name}/{mode}#{i}", rec, False))
            if not rec["any_hit"]:
                cases.append((f"{path}/{name}/{mode}#{i}/as-any",
                              {**rec, "any_hit": True, **({"emit_attrs": False}
                                                          if "emit_attrs" in rec else {})}, True))
        for case, rec, replayed in cases:
            rec_p = _first(rec, plain_variants) if plain_variants else rec
            nv = rec_p["tmax_tiles"].shape[0]
            out_k = kernel_fn(**rec)
            res = compare(case, [x[:nv] for x in out_k], plain_fn(**rec_p), rec["any_hit"])
            res.update(kernel=name, path=path, any_hit=rec["any_hit"], replayed=replayed,
                       plain_variants=nv, variants=rec["tmax_tiles"].shape[0])
            res["ms"] = cuda_ms(lambda rec=rec: kernel_fn(**rec), 20)
            res["plain_ms"] = cuda_ms(lambda rec=rec_p: plain_fn(**rec), 2)
            tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
            kernel_fn(**rec, tested=tested)
            res.update(bound(name, rec, len(out_k), tested))
            line = (f"  {case}: kernel {res['ms']:.4f} ms ({res['variants']} variants), plain "
                    f"{res['plain_ms']:.4f} ms ({nv} variants), bound {res['bound_ms']:.4f} ms "
                    f"({res['bound_by']}; {res['pairs']:.4g} pairs tested of "
                    f"{res['listed_pairs']:.4g} listed; bound / kernel "
                    f"{res['bound_ms'] / res['ms']:.3f})")
            if lists_fn is not None and not replayed:
                res["lists_ms"] = cuda_ms(lambda rec=rec: lists_fn(rec), 20)
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


def forward_phase(tag, bridge, randomize, beams, seeds, cfg, expected) -> dict:
    """One counted forward batch (every counter set to 0 just before, read
    just after): each kernel of `expected` must have launched and no other;
    then renders/s, the median of 5 timed batches after one more.  Returns
    the counts by kernel name."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415

    for k in KERNELS.values():
        k.launches = 0
    with torch.no_grad():
        img = main_path.render_batch(bridge, randomize, beams, seeds, cfg)
        torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"[{tag}/forward] image {tuple(img.shape)} mean {img.mean().item():.6g} "
        f"max {img.max().item():.6g}; launches {launches}")
    if tuple(img.shape) != (len(seeds), cfg.height, cfg.width, 3):
        raise AssertionError(f"unexpected image shape {tuple(img.shape)}")
    if not torch.isfinite(img).all() or img.abs().max() == 0:
        raise AssertionError("image is not finite or is all zero")
    if any(launches[n] <= 0 for n in expected):
        raise AssertionError(f"{tag}: a kernel of the path was never launched: {launches}")
    if any(count > 0 for n, count in launches.items() if n not in expected):
        raise AssertionError(f"{tag}: a kernel of another route was launched: {launches}")
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
    log(f"[{tag}/forward] {len(seeds) / med:.4f} renders/s (median batch {med:.4f} s; "
        f"batches {[round(t, 4) for t in times]})")
    return launches


def pattern_phase(tag, bridge, randomize, beams, seeds, cfg, dev) -> None:
    """Pattern step after a one-variant warm-up (the first backward in a
    process loads the backward ops' kernels): loss and a finite, nonzero
    (144, 3) beam gradient, s/step and peak device memory."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    main_path.pattern_step(bridge, randomize, beams, seeds[:1], cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grad = main_path.pattern_step(bridge, randomize, beams, seeds, cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[{tag}/pattern_step] loss {loss.item():.6g} |grad| {grad.norm().item():.6g} "
        f"{step_s:.4f} s/step, peak {peak:.3f} GiB")
    if tuple(grad.shape) != (144, 3) or not torch.isfinite(grad).all() or grad.abs().max() == 0:
        raise AssertionError("beam gradient is not a finite nonzero (144, 3) tensor")


def probe_phase(dev) -> dict:
    """X2 through the probe's entry point with its counter set to 0 just
    before and read just after, then bit for bit against its plain version
    on that input; its time, bound and measured rate of unfused FP32
    operations.  Then the kernel roof: B3 where every pair is tested.
    Returns X2's entry of the kernels line."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import perf_probe  # noqa: PLC0415
    from fireflies_tpu_torch.perf_probe import PEAK_BYTES, PEAK_FP32_OPS  # noqa: PLC0415

    perf_probe.VPU_KERNEL.launches = 0
    roof = perf_probe.vpu_roof(dev)
    torch.cuda.synchronize()
    launches = perf_probe.VPU_KERNEL.launches
    if launches <= 0:
        raise AssertionError("probe: X2 was never launched")
    x = perf_probe.vpu_input(dev)
    out, plain = perf_probe.vpu_rounds(x), perf_probe.vpu_rounds_plain(x)
    differ = int((out != plain).sum())
    if differ or not torch.isfinite(out).all():
        raise AssertionError(f"probe: X2 differs from its plain version on {differ} elements")
    nbytes = 2 * x.numel() * x.element_size()
    mem_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, roof["ops"] / PEAK_FP32_OPS * 1e3
    rate = roof["ops"] / roof["ms"] * 1e3
    log(f"[probe/X2] {tuple(x.shape)} x {perf_probe.VPU_ROUNDS} rounds: kernel {roof['ms']:.4f} "
        f"ms, plain {roof['plain_ms']:.4f} ms, bitwise equal; bound {max(mem_ms, ops_ms):.4f} ms "
        f"({roof['ops']:.4g} operations; bytes {mem_ms:.4f} ms); {rate:.4g} unfused FP32 "
        f"operations/s = {rate / PEAK_FP32_OPS:.3f} of {PEAK_FP32_OPS:.4g}; {launches} launches")
    kr = perf_probe.kernel_roof(dev)
    log(f"[probe/kernel roof] B3, {kr['tested_pairs']:.4g} pairs tested of {kr['listed_pairs']:.4g}"
        f": {kr['ms']:.4f} ms, {kr['gtests_s']:.4f} Gtests/s, bound {kr['bound_ms']:.4f} ms "
        f"(bound / kernel {kr['bound_ms'] / kr['ms']:.3f})")
    return {"name": "vpu_probe", "route": "cuda", "source": "fireflies_tpu_torch/csrc/vpu_probe.cu",
            "replaces": "tools/perf_probe.py:390", "path": "probe", "launches": launches,
            "ops_per_pair": perf_probe.VPU_OPS_PER_ROUND,  # unfused, per element and round
            "max_abs_err": 0.0, "ms": roof["ms"], "plain_ms": roof["plain_ms"],
            "bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms > ops_ms else "operations",
            "library_ms": None, "fp32_ops_per_s": rate}


def mxu_phase(dev) -> dict:
    """X1 through its entry point on the camera rays of the main and
    reference shapes (16 variants, 512x512, jittered as the paths cast
    them, the origin the camera): once with t_max = 1e30, once with a per-ray
    t_max of each variant's median hit distance times 0.9-1.1, with X1's
    counter set to 0 just before and read just after.  The per-ray result
    must be the first one cut after the scan.  Each launch is replayed
    through the kernel and its plain version (first 2 variants), closest and
    as any-hit, and the two must agree exactly (both round every operation
    alike).  X1's prims are held against B6's (`intersect_shared_packed`,
    64-face clusters front to back) on the same rays: at most 1e-3 of the
    live rays may differ, since the two tests round edges differently.
    Times of X1, its plain version (on the t_max = 1e30 launches) and B6,
    and X1's bound.  Returns X1's entry of the kernels line."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.experiments import intersect_mxu as mx  # noqa: PLC0415
    from fireflies_tpu_torch.perf_probe import OPS_PER_PAIR, cuda_ms  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import intersect_kernel as ik  # noqa: PLC0415
    from fireflies_tpu_torch.render.rays import camera_rays_tiled  # noqa: PLC0415

    seeds = list(range(BATCH))
    scenes = []
    for tag in ("main", "reference"):
        bridge, randomize, beams = main_path.build(dev, resolution=main_path.SHAPES[tag][0])
        rs = main_path.scene_batch(bridge, randomize, beams, main_path.generators(seeds, dev))
        _, d, _ = camera_rays_tiled(rs.camera, SIZE, SIZE, gens=main_path.generators(seeds, dev))
        scenes.append((tag, rs.camera.to_world[:, :3, 3].contiguous(), d, rs.geometry.vertices,
                       rs.geometry.faces))
    torch.cuda.synchronize()

    mx.KERNEL.launches = 0
    mx.KERNEL.recorded = []
    with torch.no_grad():
        outs = []
        for tag, cam, d, verts, faces in scenes:
            t, prim = mx.intersect_mxu_shared(cam, d, verts, faces)
            u = torch.rand(d.shape[:2], device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
            median = torch.where(prim >= 0, t, torch.nan).nanmedian(dim=1, keepdim=True).values
            t_max = median * (0.9 + 0.2 * u)
            outs.append((tag, faces.shape[0], t, prim, t_max,
                         mx.intersect_mxu_shared(cam, d, verts, faces, t_max=t_max)))
    torch.cuda.synchronize()
    launches = mx.KERNEL.launches
    recorded, mx.KERNEL.recorded = mx.KERNEL.recorded, None
    if launches <= 0:
        raise AssertionError("mxu: X1 was never launched")
    for tag, n_faces, t, prim, t_max, (t_cut, p_cut) in outs:
        kept = (prim >= 0) & (t < t_max)
        n_hit = int((prim >= 0).sum())
        log(f"[mxu/{tag}] {tuple(prim.shape)} rays: {n_hit} hit with t_max 1e30, "
            f"{int(kept.sum())} with the per-ray t_max ({int(kept.sum()) / max(n_hit, 1):.3f})")
        if not torch.isfinite(t).all() or n_hit == 0 or int(prim.max()) >= n_faces:
            raise AssertionError(f"mxu/{tag}: t not finite, no hit, or a prim out of range")
        if not (torch.equal(p_cut, torch.where(kept, prim, -1))
                and torch.equal(t_cut, torch.where(kept, t, 0.0))):
            raise AssertionError(f"mxu/{tag}: the per-ray t_max is not the scan's result cut")

    results = {}
    for (tag, cam, d, verts, faces), pair in zip(scenes, (recorded[0:2], recorded[2:4])):
        woop64, boxes64 = ik.pack_triangles_woop(verts, faces, cam, chunk=ik.CHUNK)
        order = ik.cluster_order(boxes64)
        for rec, cut in zip(pair, ("1e30", "per-ray")):
            b6 = lambda rec=rec: ik.intersect_shared_packed(  # noqa: E731
                rec["dirs_soa"], rec["tmax_tiles"], woop64, boxes64, rec["t_min"], order=order)
            t6, p6 = b6()
            for any_hit in (False, True):
                case = f"mxu/{tag}/t_max {cut}/" + ("as-any" if any_hit else "closest")
                rec = {**rec, "any_hit": any_hit}
                rec_p = _first(rec, 2)
                out_k = mx.intersect_mxu_packed(**rec)
                plain = mx.intersect_mxu_packed_plain(**rec_p)
                res = compare(case, [x[:2] for x in out_k], plain, any_hit)
                if not all(torch.equal(k[:2], p) for k, p in zip(out_k, plain)):
                    raise AssertionError(f"{case}: the kernel and its plain version differ")
                res["ms"] = cuda_ms(lambda rec=rec: mx.intersect_mxu_packed(**rec), 20)
                line = f"  {case}: kernel {res['ms']:.4f} ms ({BATCH} variants)"
                if cut == "1e30" and not any_hit:
                    res["plain_ms"] = cuda_ms(
                        lambda rec=rec_p: mx.intersect_mxu_packed_plain(**rec), 2)
                    res["b6_ms"] = cuda_ms(b6, 20)
                    line += (f", plain {res['plain_ms']:.4f} ms (2 variants), "
                             f"B6 {res['b6_ms']:.4f} ms")
                tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
                mx.intersect_mxu_packed(**rec, tested=tested)
                res.update(bound(MXU, rec, 2, tested))
                live = rec["tmax_tiles"] >= 0
                differ = int(((out_k[1] != p6) & live).sum())
                same = (out_k[1] == p6) & (p6 >= 0)
                dt = float((out_k[0] - t6).abs()[same].max()) if bool(same.any()) else 0.0
                res.update(b6_differ=differ, b6_max_dt=dt)
                log(line + f", bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
                    f"{res['pairs']:.4g} pairs tested of {res['listed_pairs']:.4g}; bound / kernel "
                    f"{res['bound_ms'] / res['ms']:.3f}); against B6: {differ} of "
                    f"{int(live.sum())} live rays differ, max |dt| {dt:.3g}")
                if differ > 1e-3 * int(live.sum()):
                    raise AssertionError(f"{case}: {differ} rays differ from B6")
                results[case] = res

    main, ref = results["mxu/main/t_max 1e30/closest"], results["mxu/reference/t_max 1e30/closest"]
    any_hit = results["mxu/main/t_max 1e30/as-any"]
    return {"name": MXU, "route": "cuda", "source": "fireflies_tpu_torch/csrc/intersect_mxu.cu",
            "replaces": "experiments/intersect_mxu.py:253", "path": "mxu", "launches": launches,
            "ops_per_pair": OPS_PER_PAIR[MXU],
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "plain_variants": 2,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "tested_pairs": main["pairs"], "listed_pairs": main["listed_pairs"],
            "library_ms": None, "any_hit_ms": any_hit["ms"],
            "any_hit_bound_ms": any_hit["bound_ms"], "b6_ms": main["b6_ms"],
            "reference_ms": ref["ms"], "reference_plain_ms": ref["plain_ms"],
            "reference_bound_ms": ref["bound_ms"], "reference_b6_ms": ref["b6_ms"]}


SIZE = 512
BATCH = 16
MXU = "intersect_mxu_shared"
B1, B3 = "intersect_shared_culled", "intersect_general"
B2, B4 = "intersect_stream_culled", "intersect_stream_general_culled"
B5 = "intersect_general_culled"
B6, B7S, B7G = "intersect_shared", "intersect_stream", "intersect_stream_general"
SOURCES = {
    B1: ("fireflies_tpu_torch/csrc/intersect_shared_culled.cu",
         "fireflies_tpu/render/pallas/intersect_culled.py:700"),
    B3: ("fireflies_tpu_torch/csrc/intersect_general.cu",
         "fireflies_tpu/render/pallas/intersect_kernel.py:602"),
    B2: ("fireflies_tpu_torch/csrc/intersect_stream_culled.cu",
         "fireflies_tpu/render/pallas/intersect_stream.py:644"),
    B4: ("fireflies_tpu_torch/csrc/intersect_stream_general_culled.cu",
         "fireflies_tpu/render/pallas/intersect_stream.py:1097"),
    B5: ("fireflies_tpu_torch/csrc/intersect_general_culled.cu",
         "fireflies_tpu/render/pallas/intersect_culled.py:465"),
    B6: ("fireflies_tpu_torch/csrc/intersect_shared.cu",
         "fireflies_tpu/render/pallas/intersect_kernel.py:522"),
    B7S: ("fireflies_tpu_torch/csrc/intersect_stream.cu",
          "fireflies_tpu/render/pallas/intersect_stream.py:713"),
    B7G: ("fireflies_tpu_torch/csrc/intersect_stream_general.cu",
          "fireflies_tpu/render/pallas/intersect_stream.py:740"),
}


def main() -> int:
    import torch  # noqa: PLC0415

    # 1. device
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        return 1

    from fireflies_tpu_torch import _build, main_path  # noqa: PLC0415
    from fireflies_tpu_torch.perf_probe import OPS_PER_PAIR, nvidia_smi  # noqa: PLC0415

    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # 2. build
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}"
        + (" (already built)" if cached else ""))
    report = _build.library_path().with_suffix(".log")
    for line in report.read_text().splitlines() if report.exists() else []:
        if "registers" in line or "Compiling entry" in line or line.startswith("=="):
            log("  " + line.strip())

    seeds = list(range(BATCH))
    kres, launches, kernel_path = {}, {}, {}
    # (shape in main_path.SHAPES, kernels of the path, replay only the first
    # launch of each (kernel, mode), plain versions' variants, pattern step)
    paths = [
        ("main", (B1, B3), False, None, True),
        ("reference", (B2, B4), True, 2, True),
        ("mid", (B1, B5), True, 2, False),
        ("main_unculled", (B6, B3), True, 2, False),
        ("reference_unculled", (B7S, B7G), True, 2, True),
    ]
    for tag, expected, first_only, plain_nv, step in paths:
        t_path = time.perf_counter()
        resolution, shape_cfg = main_path.SHAPES[tag]
        cfg = main_path.bench_config(size=SIZE, **shape_cfg)
        bridge, randomize, beams = main_path.build(dev, resolution=resolution)
        log(f"[{tag}/kernels] {BATCH} variants x {SIZE}x{SIZE} rays, spp {cfg.spp}, "
            f"{len(bridge._faces)} faces (vocalfold resolution {resolution}), tile_cull "
            f"{cfg.tile_cull}" + (f"; first launch of each (kernel, mode) only, plain versions "
                                  f"on the first {plain_nv} variants" if first_only
                                  else "; every launch"))
        res = kernel_phase(tag, lambda: main_path.render_batch(bridge, randomize, beams, seeds,
                                                               cfg), first_only, plain_nv)
        kres.update(res)
        if tag == "main":
            log("[main/reference]")
            reference_phase(bridge, randomize, beams, dev)
        counts = forward_phase(tag, bridge, randomize, beams, seeds, cfg, expected)
        for name in expected:
            if name not in kernel_path:
                kernel_path[name] = tag
                launches[name] = counts[name]
        if step:
            pattern_phase(tag, bridge, randomize, beams, seeds, cfg, dev)
        log(f"[{tag}] {time.perf_counter() - t_path:.1f} s")

    t_mxu = time.perf_counter()
    x1 = mxu_phase(dev)
    log(f"[mxu] {time.perf_counter() - t_mxu:.1f} s")

    t_probe = time.perf_counter()
    x2 = probe_phase(dev)
    log(f"[probe] {time.perf_counter() - t_probe:.1f} s")

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in kres.values() if r["kernel"] == name and r["path"] == kernel_path[name]]
        closest = next(r for r in mine if not r["any_hit"])
        # The path's own any-hit launch where it has one (shadow rays), else
        # a closest-hit launch replayed as any-hit.
        any_hit = min((r for r in mine if r["any_hit"]), key=lambda r: r["replayed"])
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "path": kernel_path[name], "launches": launches[name],
            "ops_per_pair": OPS_PER_PAIR[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": closest["ms"], "plain_ms": closest["plain_ms"],
            "plain_variants": closest["plain_variants"],
            "bound_ms": closest["bound_ms"], "bound_by": closest["bound_by"],
            "tested_pairs": closest["pairs"], "listed_pairs": closest["listed_pairs"],
            "library_ms": None,
            "any_hit_ms": any_hit["ms"], "any_hit_plain_ms": any_hit["plain_ms"],
            "any_hit_bound_ms": any_hit["bound_ms"],
        }
        if "lists_ms" in closest:
            entry["tile_lists_ms"] = closest["lists_ms"]
        kernels.append(entry)
    kernels += [x1, x2]
    over = [k["name"] for k in kernels if k["bound_ms"] > k["ms"]]
    if over:
        raise AssertionError(f"a kernel ran faster than its bound, so the bound is wrong: {over}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
