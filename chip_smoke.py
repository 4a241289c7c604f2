"""Drive the PyTorch/CUDA port's render paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Seven paths, each a batch of 16 randomized vocalfold variants at 512x512
with 2 bounces through `main_path.render_batch` / `pattern_step` /
`pose_step` (`main_path.SHAPES`):
  * main: 1440 faces, spp 1 (the reference benchmark's default; kernels B1
    for camera and shadow rays, B3 for bounce rays);
  * reference shape: 11538 faces, spp 4, coherent bounce, shared primary
    (B2 for camera and shadow rays, B4 for bounce rays, with kernel-emitted
    hit attributes);
  * mid-sized: 5288 faces, spp 1 (B1, and B5 for bounce rays);
  * main_unculled and reference_unculled: main and the reference shape with
    tile culling off (`RenderConfig.tile_cull=False`, the reference's
    FF_NO_TILE_CULL=1): B6 and B3; B7s and B7g with the attribute gather;
  * geometry and reference_geometry: the differentiable face-table
    attribute route (`static_geometry=False`: hit attributes re-derived from
    one packed row per face, so gradients reach the vertices): main with
    smooth vertex normals (B1 and B3), and bench.py's static_geom=0 row,
    the reference shape with coherent bounce and without the shared
    primary (B2 and B4 as closest hit without kernel-emitted attributes).
The kernels' bodies (`body` in the kernels line): B1, B2, B6 and B7s share
`csrc/intersect_shared.cuh` (staged batches, a slab vote per warp), B3 and
B5 `csrc/intersect_general.cuh` (staged batches, each ray tested against
the clusters its own slab test opens), B4 and B7g `csrc/intersect_stream.cuh`.
Then X1, the reference's parked matrix-unit intersection, through its own
entry point on the camera rays of the main and reference shapes, and the
probe's FP32 throughput kernel X2 and kernel roof.  On the main shape the
texture route (`analytic=False`: the beams rasterized once a step into a
256x256 projector texture, bench.py's `analytic=0` rows) runs too, on B1
and B3, and `bench.measure` gives diff-renders/s, the reference's unit.
Two loops around the render run on B1 and B3 at the main shape too: the
pattern optimizer (`optimize`) and the dataset farm (`datagen`).  Two more
paths drive the rest of the renderer's shading (`main_path.BUILDERS`):
`materials`, the reference's farm scene (vocalfold resolution 24 with
examples/vocalfold_scene.py's randomization: clearcoat, roughness and sheen
on the mucosa, a grey spot intensity) with base-colour, roughness and
normal maps (the face-table route; B1 and B3), and `emitters`, cornell_like
with a glass sphere (9046 faces), a thin translucent box, anisotropic and
flat walls, an area light, a point light's aperture and an envmap with its
NEE (B2 for camera rays, B4 for bounce rays and, from per-ray origins, for
the aperture, envmap and area-light shadow rays).  Two more load the
vocalfold scene from files, as users do (`scene_files`): `xml`
(tools/parity_scenes/vocalfold.xml through `scene_from_mitsuba_xml`) and
`yaml` (a scene description written and read back by `scene_io`, the fold
animated from OBJ frames, a Perlin texture on the mucosa); both B1 and B3.

Phases (each raises on failure, so any failure exits non-zero):
  1. device: the card's name and power limit; CUDA must be available;
  2. build: compile the CUDA kernels of fireflies_tpu_torch/csrc from
     source, one nvcc per source, all started together;
  then for each path:
  3. kernels: the kernel launches of one forward batch recorded and
     replayed through the kernel and its plain PyTorch version, with times
     and each launch's bound (from the pairs the kernel reports it tested)
     beside its least-work bound (from the pairs its inputs need, whatever
     implements them: `perf_probe.least_pairs`).
     On the main path every launch is replayed;
     on the other paths only the first launch of each (kernel, mode), and
     the plain version runs on the first 2 of the 16 variants (the kernel's
     output for those variants is compared; the plain versions are slow at
     11.5k faces);
  4. reference (main path): the CUDA path against the CPU path (plain
     versions, held against the JAX package by the tests) on a small
     deterministic render; on the geometry path the face-table render and
     its gradient with respect to a translation of the vertices;
  5. forward: `render_batch` with every launch counter set to 0 just before
     it and read just after: the path's kernels must have launched and no
     other; then renders/s (median of 5 timed batches);
  6. pattern step (one batched render of the 16 variants and one
     backward): loss and the (144, 3) beam gradient, seconds per step and
     peak device memory; on the geometry path the pose step instead (the
     path-traced L2 plus a 256x256 soft-silhouette L2 against targets
     rendered once, and its (3,) translation gradient), and none on
     reference_geometry, whose step the bench phase measures;
  the geometry paths replay without the any-hit replays and without timing
  the plain versions, and reference_geometry only its closest-hit launches
  (B2 and B4 without emitted attributes; their any-hit launches are the
  reference path's);
  on the main shape, after its pattern step:
     texture: phases 4-6 with the texture projector (the counted forward's
     launches B1 and B3 and no other);
     C2: the batched pattern step's gradient against the per-variant loop's
     accumulated gradient on 4 variants, within 1e-5 relative (1e-5 of the
     largest component absolute), as tests/test_torch_render_texture.py
     holds it on the CPU;
  then the two shading paths at 512x512, batch 16:
  materials (spp 1, 2 bounces): phase 3 on the first launch of each kernel
     and mode (plain on 2 variants, not timed); CUDA against the CPU plain
     path on 2 variants at 128x32, 2 bounces, the same generators (film
     means within 1e-5 relative, images within 1e-4 of the image's scale on
     >= 99.9% of pixels, the beam gradient within 1e-3 relative L2); phase
     5 (B1 and B3, no other; with peak memory); phase 6;
  emitters (spp 4, shared primary, 3 bounces): phase 3 on the first
     closest-hit launch of B2 and B4 and B4's first three any-hit launches
     (vertex 0's aperture, envmap and area-light shadow rays, 0 mismatches);
     CUDA against the CPU plain path at 128x32, 2 variants, 2 bounces, as
     on materials, with the gradient of the mean image to the floor's
     texture and the sphere's roughness; phase 5 (B2 and B4, no other);
  reparam (bench's 256^2 pose_reparam row: 2 variants, chunk 1024,
     `RenderConfig(reparam=True)`, render/reparam.py): one warp
     evaluation's B1 launches (the camera's aux rays, each emitter's
     shadow-feature rays: closest hit from the light, t_max 1 - 1e-3) and
     the warped pass's camera B1 and first B3 launches replayed, 0 rays
     off; the pose_reparam
     loss and translation gradient at 128x32, CUDA against the CPU plain
     path with the same generators (1e-5 relative, 1e-3 relative L2);
     `render_depth_reparam` on a translating quad within 15% of the
     analytic boundary flux, on the card alone; one counted pose step (B1
     and B3 only, at the counts `reparam_expected` derives from the code),
     then s/step and peak memory;
  scene_files (`xml`, then `yaml`; 512x512, batch 16, spp 1, 2 bounces, the
     analytic projector): the host seconds of 3 loads of the scene file;
     every B1 and B3 launch of one forward batch replayed against the plain
     versions (2 variants, 0 rays off); CUDA against the CPU plain path at
     128x32 with the beam gradient, as on materials; phase 5 (B1 5 and B3
     1 launches, no other; renders/s, peak memory); phase 6; each path's
     line with the nvidia-smi line; then `lbs` and its pose gradient on a
     synthetic 3-joint rig and `rand_perlin_2d` / the noise sampler from
     injected draws, CUDA against the CPU (1e-5 of the vertices' scale,
     1e-4 relative L2, 1e-5 absolute);
  then the two loops, each with every counter set to 0 just before it and
  read just after (B1 and B3 launched, no other kernel):
  optimize: `optim.optimize_pattern_through_render` over
     `main_path.variant_loss` (16 variants a step at 512x512, spp 1, 2
     bounces, 144 beams, the analytic projector, `dot_coverage_objective`,
     Adam at lr 5e-3, respawn on, 3 steps): each step's loss, s/step of
     steps 2-3, peak memory; the beams finite and unit-norm (1e-5), step 1's
     loss equal to one direct batched render's (1e-5 relative); then
     `optimize_point_pattern` at the reference's defaults (500 points,
     512^2, 200 steps), whose last loss must be below its first;
  datagen: the AOV integrators (`render_depth`, `render_segmentation`,
     `render_from_laser`) on 2 variants at 128x32, CUDA against the CPU
     plain path (segmentation equal but at t-ties on at most 1e-4 of the
     pixels, depths within 1e-5 relative, the laser's valid masks equal);
     one counted farm dispatch (`main_path.datagen_batch`, 8 frames, spp
     4); bench's datagen row at its full parameters (accepted frames/s, one
     JSON line), counted too;
  estimation: pattern initialization (`estimation.initialize_laser`) on
     the main shape at `LaserConfig()`'s defaults (150 beams, 16 depth maps
     at 256x256), projector fov 30: GRID, RANDOM, POISSON and SMARTY, each
     counted (SMARTY: one B1 launch, its depth maps in one batch, and no
     other kernel; the other modes: none), beams finite, unit and forward,
     SMARTY's seconds split into depth maps, Bridson (host) and the rest;
     SMARTY on the card against the CPU plain path on the same variants
     at 128x32, 4 maps (depth maps and radius map within 1e-5 relative,
     the re-aimed beams of the same pixels within 1e-5); the SMARTY
     pattern's epipolar lines at 256x256 against the CPU (1e-5 of the
     max); `optimize_pattern_through_render` from the SMARTY beams as in
     optimize (counted: B1 and B3, no other), s/step and peak memory;
  films (`films_phase`): odd_film, the main shape at 500x500 (the
     permutation route of `rays.camera_rays_tiled`: partial 128x16 blocks,
     the last ray tile padded): every B1 and B3 launch replayed (plain on
     2 variants, 0 rays off, each replay over the padded ray count), CUDA
     against the CPU plain path at 200x120 with the beam gradient, phase 5
     (B1 5 and B3 1, no other), phase 6; bands, the 512^2 and 500^2 films
     in 4 bands (`render_rgb(film_y0=, film_full_height=)`) at pixel
     centres and one bounce against the whole film (each pixel within 1e-6
     relative), counted (B1); quadrature, hello_world and cornell_like at
     100^2: the path tracer at one vertex within 1e-5 of the quadrature
     witness (`render/quadrature.py`), the mean of 64 path-tracer variants
     at 2 bounces against the quadrature at n_mu 16, n_phi 32 within the
     noise, counted (B1 and B3); parallel, `parallel/` at world size 1 over
     NCCL (only the group's start and the farm's broadcast reach NCCL at
     one rank): `psum_grad_step` over `main_path.variant_loss` against one
     process, `render_tile_parallel` equal to `render_rgb`,
     `all_gather_frames` the identity, a counted
     `datagen.generate_dataset_parallel` of 8 frames (B1 and B3); blocker, the
     blocker scene's warped-area gradient and its finite difference over
     8192 variants, each with its standard error: within two combined
     standard errors of each other, the gradient above four of its own;
  7. probe: X2 (`perf_probe.vpu_roof`, its counter set to 0 just before and
     read just after) bit for bit against its plain version, its time,
     bound and rate of unfused FP32 operations; the kernel roof (B3 on a
     workload where every pair is tested);
  8. mxu: X1 (`experiments.intersect_mxu.intersect_mxu_shared`, its counter
     set to 0 just before and read just after) on 16 variants' camera rays
     at 512x512 from the main and reference shapes, with t_max = 1e30 and
     with a per-ray t_max that cuts about half the hits; each launch
     replayed through the kernel and its plain version (2 variants), t and
     prim bit for bit (its split-TF32 d' only filters the pairs it then
     tests as the plain version does), and as any-hit, which must give the
     closest-hit outputs; X1's prims
     against B6's on the same rays; times and bounds.
  9. bench: `bench.measure` (diff-renders/s: batch x repeats over the best
     window's wall time, after one warm-up step) for the headline row, the
     texture row, the reference shape (resolution 75, spp 4, coherent
     bounce, shared primary) and the face-table route's rows (static_geom=0,
     smooth=1, pose_soft), each with few repeats and trials; one JSON line
     each.
Then one JSON line with the kernels (each with its fused operations per
tested pair, `ops_per_pair`, its counted launches on every path that runs
it, `launches_by_path` (`estimation` for SMARTY's depth maps,
`estimation_optimize` for the optimizer from its pattern, `odd_film`,
`bands`, `quadrature` and `parallel` for the films phase), and for the
nine intersection kernels
`least_pairs` and `least_bound_ms`, and for each path beyond its own that
replays it (geometry, reference_geometry, materials, emitters, reparam,
estimation, xml, yaml, odd_film) its cases,
mismatches and times (B4's any-hit times on emitters); for X1 beside them its tensor-core
multiply-adds and reciprocals per pair and the bounds with d' on the FP32
pipe; for X2 its
unfused operations per element and round; the script fails if a kernel ran
faster than its bound),
the nvidia-smi line, and the result line `{"ok": true, "device": {...}}`
last.
"""

from __future__ import annotations

import json
import math
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
    were tested against after the slab test, its warp's vote in B1, B2, B6,
    B7s and X1, its own in B3, B4, B5 and B7g) x the faces of a cluster x
    `perf_probe.OPS_PER_PAIR`, the fused count of its pair test; the
    per-cluster slab tests are left out.
    Also the pairs on the tile lists (every cluster without lists), which
    the kernel tests at most."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import perf_probe  # noqa: PLC0415
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
    nc = rec["boxes"].shape[2]
    faces_per_cluster = perf_probe.faces_per_cluster(rec)
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


def least_bound(name: str, rec: dict, out) -> dict:
    """The work a launch's inputs need whatever implements it: the pairs of
    each live ray with the faces of the listed clusters its own slab test
    opens, tfar capped at the kernel's own t (`perf_probe.least_pairs`),
    and their operations over the card's FP32 rate.  Unlike the bound of
    `bound`, a kernel that tests fewer pairs does not lower it."""
    from fireflies_tpu_torch import perf_probe  # noqa: PLC0415

    pairs = perf_probe.least_pairs(rec, out[0], out[1])
    ms = pairs * perf_probe.OPS_PER_PAIR[name] / perf_probe.PEAK_FP32_OPS * 1e3
    return {"least_pairs": pairs, "least_bound_ms": ms}


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


def kernel_phase(path: str, drive, per_mode: dict | None, plain_variants: int | None,
                 modes=("closest", "any"), replay_any: bool = True,
                 time_plain: bool = True) -> dict:
    """Each kernel against its plain version on the inputs a path gives it:
    one forward batch records every launch's inputs, and each launch of
    `modes` (with `per_mode`, the first per_mode[mode] of each kernel and
    mode) is replayed through the kernel and the plain version, the latter
    on the first
    `plain_variants` variants when given.  With `replay_any` each
    closest-hit launch is replayed as any-hit too, since the scene casts no
    shadow where an emitter lights it and a path's own any-hit launches
    find few or no blockers.  Kernel times exclude building the tile lists,
    which are timed on their own (`lists_ms`); the plain version is timed
    only with `time_plain`."""
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
        cases, seen = [], {"closest": 0, "any": 0}
        limit = per_mode or {}
        for i, rec in enumerate(recorded):
            mode = "any" if rec["any_hit"] else "closest"
            if mode not in modes or seen[mode] >= limit.get(mode, len(recorded)):
                continue
            seen[mode] += 1
            cases.append((f"{path}/{name}/{mode}#{i}", rec, False))
            if replay_any and not rec["any_hit"]:
                cases.append((f"{path}/{name}/{mode}#{i}/as-any",
                              {**rec, "any_hit": True, **({"emit_attrs": False}
                                                          if "emit_attrs" in rec else {})}, True))
        for case, rec, replayed in cases:
            rec_p = _first(rec, plain_variants) if plain_variants else rec
            nv = rec_p["tmax_tiles"].shape[0]
            out_k = kernel_fn(**rec)
            res = compare(case, [x[:nv] for x in out_k], plain_fn(**rec_p), rec["any_hit"])
            res.update(kernel=name, path=path, any_hit=rec["any_hit"], replayed=replayed,
                       plain_variants=nv, variants=rec["tmax_tiles"].shape[0],
                       rays=rec["tmax_tiles"][0].numel())
            res["ms"] = cuda_ms(lambda rec=rec: kernel_fn(**rec), 20)
            res["plain_ms"] = cuda_ms(lambda rec=rec_p: plain_fn(**rec), 2) if time_plain else None
            tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
            kernel_fn(**rec, tested=tested)
            res.update(bound(name, rec, len(out_k), tested))
            res.update(least_bound(name, rec, out_k))
            plain = (f"plain {res['plain_ms']:.4f} ms ({nv} variants)" if time_plain
                     else f"plain not timed ({nv} variants compared)")
            line = (f"  {case}: kernel {res['ms']:.4f} ms ({res['variants']} variants), {plain}, "
                    f"bound {res['bound_ms']:.4f} ms "
                    f"({res['bound_by']}; {res['pairs']:.4g} pairs tested of "
                    f"{res['listed_pairs']:.4g} listed; bound / kernel "
                    f"{res['bound_ms'] / res['ms']:.3f}); least {res['least_pairs']:.4g} pairs, "
                    f"{res['least_bound_ms']:.4f} ms (least / kernel "
                    f"{res['least_bound_ms'] / res['ms']:.3f})")
            if lists_fn is not None and not replayed:
                res["lists_ms"] = cuda_ms(lambda rec=rec: lists_fn(rec), 20)
                line += f", tile lists {res['lists_ms']:.4f} ms"
            log(line)
            results[case] = res
    return results


def reference_phase(tag, bridge, randomize, beams, dev, cfg, analytic: bool = True,
                    grad=()) -> None:
    """Two variants rendered with `cfg` (a 128x32 film) on the card and
    through the plain versions on the CPU, from the same parameters and
    the same generators (`rays.HostDraws`: both renders take the same
    camera, bounce, aperture, envmap and area-light draws): each variant's
    film mean within 1e-5 relative, and the pixels within 1e-4 of the
    image's scale (the 99.9th percentile pixel, or a brighter pixel's own
    value) on >= 99.9% of them.  With `analytic=False` the projector is the
    texture route's.  `grad` names the leaves of the mean image's gradient,
    each shared by both variants: "beams" (the (144, 3) beams),
    "translation" (a (3,) translation of every vertex) or a param key; each
    gradient finite, nonzero and within 1e-3 relative L2 (the texture
    lookups and face-table rows add back atomically on the card)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.render import render_rgb  # noqa: PLC0415
    from fireflies_tpu_torch.render.rays import HostDraws  # noqa: PLC0415

    base = [randomize(torch.Generator(device=dev).manual_seed(s), 0) for s in (7, 8)]

    def run(device):
        params = [{k: v.to(device) for k, v in p.items()} for p in base]
        leaves = {}
        for name in grad:
            if name == "beams":
                leaves[name] = beams.detach().to(device).requires_grad_(True)
            elif name == "translation":
                leaves[name] = torch.zeros(3, device=device, requires_grad=True)
            else:
                leaves[name] = params[0][name].detach().clone().requires_grad_(True)
        for p in params:
            p.update({k: v for k, v in leaves.items() if k not in ("beams", "translation")})
            if "translation" in leaves:
                p.update({k: v + leaves["translation"] for k, v in p.items()
                          if k.endswith(".vertex_positions")})
            p.update(main_path.projector_params(leaves.get("beams", beams.to(device)), analytic))
        gens = HostDraws(torch.Generator().manual_seed(100 + s) for s in (7, 8))
        with torch.set_grad_enabled(bool(grad)):
            img = render_rgb(bridge.assemble(params), gens, cfg)
        if grad:
            img.mean().backward()
        return img.detach().cpu(), [leaf.grad.cpu() for leaf in leaves.values()]

    (img_k, grads_k), (img_p, grads_p) = run(dev), run(torch.device("cpu"))
    # 1e-4 of the image's scale: its 99.9th percentile pixel, so that a
    # highlight (a glossy view of a bright envmap texel) does not loosen
    # every other pixel, or the pixel's own value where it is brighter.
    level = img_p.abs().amax(-1)
    scale = torch.maximum(torch.quantile(level.flatten(), 0.999), level)
    bad = ((img_k - img_p).abs().amax(-1) > 1e-4 * scale).float().mean().item()
    mean_k, mean_p = img_k.mean(dim=(1, 2, 3)), img_p.mean(dim=(1, 2, 3))
    mean_rel = float(((mean_k - mean_p).abs() / mean_p).max())
    log(f"  CUDA vs CPU plain path ({cfg.width}x{cfg.height}, 2 variants, spp {cfg.spp}, "
        f"{cfg.max_bounces} bounces, static_geometry {cfg.static_geometry}, "
        f"{'analytic' if analytic else 'texture'} projector, the same generators): {bad:.2e} of "
        f"pixels beyond 1e-4 of the image's scale (its 99.9th percentile "
        f"{float(scale.min()):.4g}, max {img_p.max().item():.4g}); film means {mean_k.tolist()} "
        f"against {mean_p.tolist()}, {mean_rel:.3g} relative")
    failed = [] if (torch.isfinite(img_k).all() and img_p.max() > 0 and bad <= 1e-3
                    and mean_rel <= 1e-5) else ["the render"]
    for name, g_k, g_p in zip(grad, grads_k, grads_p):
        rel = float((g_k - g_p).norm() / g_p.norm())
        log(f"  gradient of the mean image to {name} {tuple(g_p.shape)}: |grad| "
            f"{g_k.norm().item():.6g} against {g_p.norm().item():.6g}, relative L2 {rel:.3g}")
        if not (torch.isfinite(g_k).all() and g_p.abs().max() > 0 and rel <= 1e-3):
            failed.append(f"the gradient to {name}")
    if failed:
        raise AssertionError(f"{tag}: the CUDA path disagrees with the CPU plain path: {failed}")


def pose_phase(tag, bridge, randomize, beams, seeds, cfg, dev) -> None:
    """`main_path.pose_step` (one batched render of every variant, its soft
    silhouettes at main_path.SOFT_SIZE^2 and one backward) against targets
    rendered once: after one untimed step, the loss and a finite, nonzero
    (3,) translation gradient, s/step and peak device memory."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    targets = main_path.pose_targets(bridge, randomize, beams, seeds, cfg,
                                     render_seeds=[s + len(seeds) for s in seeds])
    delta = torch.zeros(3, device=dev)
    main_path.pose_step(bridge, randomize, beams, delta, seeds, targets, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grad = main_path.pose_step(bridge, randomize, beams, delta, seeds, targets, cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[{tag}/pose_step] loss {loss.item():.6g} grad {grad.tolist()} {step_s:.4f} s/step, "
        f"peak {peak:.3f} GiB")
    if (tuple(grad.shape) != (3,) or not torch.isfinite(grad).all() or grad.abs().max() == 0
            or not torch.isfinite(loss)):
        raise AssertionError("translation gradient is not a finite nonzero (3,) tensor")


def count_launches(drive) -> dict:
    """The launches of every kernel while `drive()` runs: each counter set
    to 0 just before, read just after (synchronized)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415

    for k in KERNELS.values():
        k.launches = 0
    drive()
    torch.cuda.synchronize()
    return {name: k.launches for name, k in KERNELS.items()}


def check_launches(tag: str, launches: dict, expected) -> None:
    """Each kernel of `expected` launched, no other."""
    if any(launches[n] <= 0 for n in expected):
        raise AssertionError(f"{tag}: a kernel of the path was never launched: {launches}")
    if any(count > 0 for n, count in launches.items() if n not in expected):
        raise AssertionError(f"{tag}: a kernel of another route was launched: {launches}")


def forward_phase(tag, bridge, randomize, beams, seeds, cfg, expected,
                  analytic: bool = True) -> dict:
    """One counted forward batch (every counter set to 0 just before, read
    just after): each kernel of `expected` must have launched and no other;
    then renders/s, the median of 5 timed batches after one more.  Returns
    the counts by kernel name."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    out = {}

    def drive():
        with torch.no_grad():
            out["img"] = main_path.render_batch(bridge, randomize, beams, seeds, cfg, analytic)

    launches = count_launches(drive)
    img = out["img"]
    log(f"[{tag}/forward] image {tuple(img.shape)} mean {img.mean().item():.6g} "
        f"max {img.max().item():.6g}; launches {launches}")
    if tuple(img.shape) != (len(seeds), cfg.height, cfg.width, 3):
        raise AssertionError(f"unexpected image shape {tuple(img.shape)}")
    if not torch.isfinite(img).all() or img.abs().max() == 0:
        raise AssertionError("image is not finite or is all zero")
    check_launches(tag, launches, expected)
    times = []
    with torch.no_grad():
        main_path.render_batch(bridge, randomize, beams, seeds, cfg, analytic)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            main_path.render_batch(bridge, randomize, beams, seeds, cfg, analytic)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}/forward] {len(seeds) / med:.4f} renders/s (median batch {med:.4f} s; "
        f"batches {[round(t, 4) for t in times]}), peak {peak:.3f} GiB")
    return launches


def pattern_phase(tag, bridge, randomize, beams, seeds, cfg, dev, analytic: bool = True) -> None:
    """Pattern step (one batched render of every variant, one backward)
    after a one-variant warm-up (the first backward in a process loads the
    backward ops' kernels): loss and a finite, nonzero (144, 3) beam
    gradient, s/step and peak device memory."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    main_path.pattern_step(bridge, randomize, beams, seeds[:1], cfg, analytic)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grad = main_path.pattern_step(bridge, randomize, beams, seeds, cfg, analytic)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[{tag}/pattern_step] loss {loss.item():.6g} |grad| {grad.norm().item():.6g} "
        f"{step_s:.4f} s/step, peak {peak:.3f} GiB")
    if tuple(grad.shape) != (144, 3) or not torch.isfinite(grad).all() or grad.abs().max() == 0:
        raise AssertionError("beam gradient is not a finite nonzero (144, 3) tensor")


def c2_phase(bridge, randomize, beams, seeds, cfg) -> None:
    """The batched pattern step against the per-variant loop it replaced
    (render one variant, backward, accumulate), on the same seeds: each
    variant draws from its own generator, so loss and gradient agree up to
    summation order, within 1e-5 relative (1e-5 of the largest gradient
    component absolute)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    loss, grad = main_path.pattern_step(bridge, randomize, beams, seeds, cfg)
    leaf = beams.detach().requires_grad_(True)
    loss_loop = torch.zeros((), device=beams.device)
    for seed in seeds:
        loss_i = main_path.render_batch(bridge, randomize, leaf, [seed], cfg).mean() / len(seeds)
        loss_i.backward()
        loss_loop += loss_i.detach()
    scale = float(leaf.grad.abs().max())
    err = float((grad - leaf.grad).abs().max())
    log(f"[main/C2] {len(seeds)} variants: loss {loss.item():.8g} batched, {loss_loop.item():.8g} "
        f"per variant; max |grad difference| {err:.4g} = {err / scale:.3g} of the largest "
        f"component {scale:.4g}")
    if not (torch.isfinite(grad).all() and scale > 0):
        raise AssertionError("C2: the per-variant gradient is not finite and nonzero")
    torch.testing.assert_close(loss, loss_loop, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(grad, leaf.grad, rtol=1e-5, atol=1e-5 * scale)


def materials_phase(dev, seeds) -> tuple[dict, dict]:
    """The `materials` shape (`main_path.build_materials`: the reference's
    farm scene with its randomization and material maps, face-table route):
    its first closest-hit and any-hit launch of each kernel replayed against
    the plain version (2 variants); CUDA against the CPU plain path
    (`reference_phase`, 2 bounces, the beam gradient); a counted
    forward (B1 and B3, no other) with renders/s and peak memory; one
    pattern step.  Returns (the replays, the forward's launches)."""
    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    bridge, randomize, beams, cfg = main_path.build_shape("materials", dev, SIZE)
    log(f"[materials/kernels] {len(seeds)} variants x {SIZE}x{SIZE} rays, spp {cfg.spp}, "
        f"{cfg.max_bounces} bounces, {len(bridge._faces)} faces, lobes "
        f"{sorted(bridge._lobe_flags)}, maps on {sorted(bridge._texture_mats)} (base colour) "
        f"and {[sorted(m) for m in bridge._static_maps.values()]} (roughness, normal)")
    res = kernel_phase("materials", lambda: main_path.render_batch(bridge, randomize, beams, seeds,
                                                                   cfg), FIRST, 2,
                       replay_any=False, time_plain=False)
    log("[materials/reference]")
    reference_phase("materials", bridge, randomize, beams, dev, cfg.replace(width=128, height=32),
                    grad=("beams",))
    counts = forward_phase("materials", bridge, randomize, beams, seeds, cfg, (B1, B3))
    pattern_phase("materials", bridge, randomize, beams, seeds, cfg, dev)
    return res, counts


EMITTER_GRAD_KEYS = ("mat-mesh-floor.base_color.data", "mat-sphere.roughness")


def emitters_phase(dev, seeds) -> tuple[dict, dict]:
    """The `emitters` shape (`main_path.build_emitters`: cornell_like with
    glass, thin, anisotropic and flat materials, an area light, a point
    light's aperture and an envmap; 9046 faces, the streamed route): the
    first closest-hit launch of each kernel and the first three any-hit
    launches of B4 (vertex 0's aperture, envmap and area-light shadow rays,
    per-ray origins with t_max 1 - 1e-4, 1e30 and 1 - 1e-3, -1 where dead)
    replayed against the plain versions (2 variants, 0 any-hit mismatches);
    CUDA against the CPU plain path at 2 bounces with the gradient of the
    mean image to the floor's texture and the sphere's roughness
    (`reference_phase`); a counted forward (B2 and B4, no other)
    with renders/s and peak memory.  Returns (the replays, the forward's
    launches)."""
    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    bridge, randomize, beams, cfg = main_path.build_shape("emitters", dev, SIZE)
    log(f"[emitters/kernels] {len(seeds)} variants x {SIZE}x{SIZE} rays, spp {cfg.spp}, shared "
        f"primary, {cfg.max_bounces} bounces, {len(bridge._faces)} faces, lobes "
        f"{sorted(bridge._lobe_flags)}, {len(bridge._emissive_faces)} emissive faces, envmap "
        f"{bridge._background.shape}")
    res = kernel_phase("emitters", lambda: main_path.render_batch(bridge, randomize, beams, seeds,
                                                                  cfg), {"closest": 1, "any": 3}, 2,
                       replay_any=False, time_plain=False)
    if sum(r["any_hit"] and r["kernel"] == B4 for r in res.values()) != 3:
        raise AssertionError("emitters: B4's aperture, envmap and area-light launches not replayed")
    log("[emitters/reference]")
    reference_phase("emitters", bridge, randomize, beams, dev,
                    cfg.replace(width=128, height=32, spp=1, max_bounces=2), grad=EMITTER_GRAD_KEYS)
    counts = forward_phase("emitters", bridge, randomize, beams, seeds, cfg, (B2, B4))
    return res, counts


REPARAM_SIZE, REPARAM_BATCH, REPARAM_CHUNK = 256, 2, 1024  # bench's 256^2 pose_reparam row


def _reparam_cfg(size: int):
    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    return main_path.bench_config(size=size, static_geometry=False).replace(
        reparam=True, reparam_chunk=REPARAM_CHUNK)


def reparam_expected(cfg, n_pixels: int, n_lights: int) -> dict:
    """The launches of one `pose_reparam` step, from the code: each of its
    two passes (the value's, without autograd, and the warped one) casts a
    B1 camera launch, a B1 any-hit launch for every delta emitter at every
    vertex and a B3 launch for every bounce; the warp runs only in the
    backward, once per chunk of REPARAM_CHUNK rays: a B1 closest-hit launch
    for the camera's aux rays and one for every emitter's shadow-feature
    rays."""
    chunks = -(-n_pixels // cfg.reparam_chunk)
    per_pass = {B1: 1 + n_lights * cfg.max_bounces, B3: cfg.max_bounces - 1}
    return {B1: 2 * per_pass[B1] + chunks * (1 + n_lights), B3: 2 * per_pass[B3]}


def _quad_scene(dx, dev):
    """tests/test_reparam.py's quad at z = -2 translated by dx along x,
    seen by a 60-degree camera at the origin; no lights."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch.render import types as tc  # noqa: PLC0415

    half, z = 0.5, -2.0
    verts = torch.tensor([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                         device=dev) + torch.stack([dx, 0 * dx, 0 * dx])
    one = torch.ones(1, 1, device=dev)
    mats = tc.Materials(**{f: one for f in (
        "roughness metallic specular spec_tint clearcoat clearcoat_gloss sheen sheen_tint "
        "anisotropic spec_trans flatness ior thin").split()}, base_color=torch.ones(1, 1, 3,
                                                                                    device=dev),
        emission=torch.zeros(1, 1, 3, device=dev))
    zero = torch.zeros(1, 0, device=dev)
    return tc.RenderScene(
        geometry=tc.Geometry(vertices=verts[None],
                             faces=torch.tensor([[0, 1, 2], [0, 2, 3]], device=dev),
                             face_mat=torch.zeros(2, dtype=torch.long, device=dev),
                             face_mesh=torch.zeros(2, dtype=torch.long, device=dev)),
        materials=mats,
        lights=tc.Lights(kinds=(), to_world=torch.zeros(1, 0, 4, 4, device=dev),
                         intensity=torch.zeros(1, 0, 3, device=dev), cutoff_cos=zero,
                         beam_cos=zero, active=zero.bool()),
        camera=tc.Camera(to_world=torch.eye(4, device=dev)[None],
                         fov=torch.tensor([60.0], device=dev), near=torch.tensor([0.01], device=dev),
                         far=torch.tensor([1000.0], device=dev)))


def _analytic_quad_flux(dx: float) -> float:
    """tests/test_reparam.py's quadrature of d(mean depth)/d(dx): the depth
    flux through the quad's two moving vertical edges."""
    import numpy as np  # noqa: PLC0415

    tanf = math.tan(math.radians(30.0))
    c = 2.0 * tanf
    ys = np.linspace(-0.5 / c, 0.5 / c, 4001)

    def g(x):
        return float(np.trapezoid(2.0 * np.sqrt(1.0 + (x * tanf) ** 2 + (ys * tanf) ** 2), ys))

    return (g((dx + 0.5) / c) - g((dx - 0.5) / c)) / (4.0 * c)


def reparam_phase(dev, seeds) -> tuple[dict, dict]:
    """The warped-area route (`RenderConfig(reparam=True)`, render/reparam.py)
    on the main scene at bench's 256^2 `pose_reparam` row (vocalfold 1440
    faces, batch 2, chunk 1024):
      (a) one warp evaluation's B1 launches recorded and replayed against
          the plain version: the camera's aux rays (closest hit, shared
          origin) and each delta emitter's shadow-feature rays (closest
          hit from the light, t_max 1 - 1e-3 over unnormalized segments),
          0 rays off; and the warped pass's own launches
          (`pathtracer._film_render_reparam`, which runs no value pass):
          its camera B1 launch on the warped samples in tile order and its
          first B3 launch (the bounce), 0 rays off;
      (b) the pose_reparam loss (`optim.image_l2` of the warped render
          against a detached one) and its (3,) translation gradient at
          128x32 on 2 variants, CUDA against the CPU plain path with the
          same `rays.HostDraws` generators: the loss within 1e-5 relative,
          the gradient within 1e-3 relative L2;
      (c) a witness that needs no CPU: `render_depth_reparam` on the
          translating quad (96^2, k_aux 12, radius 0.06), the mean of 3
          seeds' d(mean depth)/d(dx) within 15% of the analytic flux, and
          the detached depth's gradient below 1e-6;
      (d) one counted `main_path.pose_step` (every counter set to 0 just
          before, read just after): B1 and B3 only, at the counts
          `reparam_expected` derives; then a timed step, s/step and peak
          memory.
    The variants: the first REPARAM_BATCH of `seeds`.  Returns (the
    replays, the counted step's launches)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.optim import image_l2  # noqa: PLC0415
    from fireflies_tpu_torch.render import (  # noqa: PLC0415
        RenderConfig,
        integrators,
        lights,
        render_rgb,
    )
    from fireflies_tpu_torch.render import pathtracer  # noqa: PLC0415
    from fireflies_tpu_torch.render import reparam as rp  # noqa: PLC0415
    from fireflies_tpu_torch.render.rays import HostDraws, pixel_to_ndc  # noqa: PLC0415

    bridge, randomize, beams = main_path.build(dev)
    cfg = _reparam_cfg(REPARAM_SIZE)
    seeds = seeds[:REPARAM_BATCH]
    render_seeds = [s + 100 for s in seeds]
    log(f"[reparam] {REPARAM_BATCH} variants x {REPARAM_SIZE}x{REPARAM_SIZE}, "
        f"{len(bridge._faces)} faces, {cfg.max_bounces} bounces, k_aux {cfg.reparam_k_aux}, "
        f"radius {cfg.reparam_radius}, chunk {cfg.reparam_chunk}")

    # (a) the first chunk's warp: aux rays, then one shadow set per emitter.
    scene, gens = main_path.pose_scene(bridge, randomize, beams, torch.zeros(3, device=dev),
                                       seeds, render_seeds)
    light_pos = torch.stack(lights.emitter_positions(scene.lights, scene.projector), dim=1)
    n_lights = light_pos.shape[1]
    warp = rp.make_warp_field(scene.camera, scene.geometry, gens, k_aux=cfg.reparam_k_aux,
                              radius=cfg.reparam_radius, light_positions=light_pos)
    pix = torch.arange(REPARAM_CHUNK, device=dev)
    u = pixel_to_ndc((pix % REPARAM_SIZE + 0.5).float(), (pix // REPARAM_SIZE + 0.5).float(),
                     REPARAM_SIZE, REPARAM_SIZE).expand(REPARAM_BATCH, -1, -1)
    res = kernel_phase("reparam", lambda: warp(u), {"closest": 1 + n_lights}, None,
                       modes=("closest",), replay_any=False)
    if len(res) != 1 + n_lights or any(r["kernel"] != B1 or r["mismatched"] for r in res.values()):
        raise AssertionError(f"reparam: the aux and shadow-feature replays: {list(res)}")
    # The warped pass alone (pathtracer._film_render_reparam; render_rgb
    # would run the value pass first): its camera launch (B1 on the
    # warped NDC samples in tile order) and its first bounce launch (B3).
    warped = kernel_phase("reparam_warped", lambda: pathtracer._film_render_reparam(
        scene, gens, cfg), {"closest": 1}, None, modes=("closest",), replay_any=False)
    if (sorted(r["kernel"] for r in warped.values()) != sorted([B1, B3])
            or any(r["mismatched"] for r in warped.values())):
        raise AssertionError(f"reparam: the warped pass's replays: {list(warped)}")
    res.update({case: dict(r, path="reparam") for case, r in warped.items()})

    # (b) CUDA against the CPU plain path.
    base = [randomize(torch.Generator(device=dev).manual_seed(s), 0) for s in (7, 8)]
    small = cfg.replace(width=128, height=32)

    def run(device):
        params = [{k: v.to(device) for k, v in p.items()} for p in base]
        delta = torch.zeros(3, device=device, requires_grad=True)
        for p in params:
            p.update({k: v + delta for k, v in p.items() if k.endswith(".vertex_positions")})
            p.update(main_path.projector_params(beams.to(device)))
        scene_d = bridge.assemble(params)
        with torch.no_grad():
            target = render_rgb(scene_d, HostDraws(torch.Generator().manual_seed(200 + s)
                                                   for s in (7, 8)), small.replace(reparam=False))
        img = render_rgb(scene_d, HostDraws(torch.Generator().manual_seed(100 + s)
                                            for s in (7, 8)), small)
        loss = image_l2(img, target)
        loss.backward()
        return loss.item(), delta.grad.cpu()

    t0 = time.perf_counter()
    (loss_k, g_k), (loss_p, g_p) = run(dev), run(torch.device("cpu"))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    g_rel = float((g_k - g_p).norm() / g_p.norm())
    log(f"[reparam/reference] pose_reparam loss at 128x32, 2 variants: {loss_k:.8g} against the "
        f"CPU's {loss_p:.8g} ({loss_rel:.3g} relative); translation gradient {g_k.tolist()} "
        f"against {g_p.tolist()} ({g_rel:.3g} relative L2); {time.perf_counter() - t0:.1f} s")
    if not (math.isfinite(loss_k) and loss_rel <= 1e-5 and torch.isfinite(g_k).all()
            and g_p.abs().max() > 0 and g_rel <= 1e-3):
        raise AssertionError("reparam: the CUDA path disagrees with the CPU plain path")

    # (c) the analytic witness on the card alone.
    ref = _analytic_quad_flux(0.3)
    grads = []
    for seed in range(3):
        dx = torch.tensor(0.3, device=dev, requires_grad=True)
        depth = rp.render_depth_reparam(_quad_scene(dx, dev), RenderConfig(width=96, height=96),
                                        [torch.Generator(device=dev).manual_seed(seed)],
                                        k_aux=12, radius=0.06)
        grads.append(float(torch.autograd.grad(depth.mean(), dx)[0]))
    dx = torch.tensor(0.3, device=dev, requires_grad=True)
    plain = integrators.render_depth_differentiable(_quad_scene(dx, dev),
                                                   RenderConfig(width=128, height=16))
    g_plain = float(torch.autograd.grad(plain.mean(), dx)[0])
    witness = sum(grads) / len(grads)
    log(f"[reparam/witness] d(mean depth)/d(dx) of the translating quad at 96^2: {witness:.6g} "
        f"(seeds {grads}) against the analytic {ref:.6g} ({witness / ref - 1:+.4f}); detached "
        f"{g_plain:.3g}")
    if abs(witness / ref - 1) > 0.15 or abs(g_plain) >= 1e-6:
        raise AssertionError("reparam: the warped depth gradient misses the analytic flux")

    # (d) the counted pose_reparam step, then a timed one.
    targets = main_path.pose_targets(bridge, randomize, beams, seeds, cfg,
                                     render_seeds=[s + 50 for s in seeds])
    delta = torch.zeros(3, device=dev)
    out = {}

    def step():
        out["loss"], out["grad"] = main_path.pose_step(bridge, randomize, beams, delta, seeds,
                                                       targets, cfg, render_seeds=render_seeds)

    t0 = time.perf_counter()
    counts = count_launches(step)
    first_s = time.perf_counter() - t0
    expected = reparam_expected(cfg, REPARAM_SIZE * REPARAM_SIZE, n_lights)
    log(f"[reparam/pose_step] launches {counts}; derived B1 {expected[B1]}, B3 {expected[B3]}; "
        f"first step {first_s:.3f} s")
    check_launches("reparam", counts, (B1, B3))
    if counts[B1] != expected[B1] or counts[B3] != expected[B3]:
        raise AssertionError(f"reparam: launches {counts} differ from the derived {expected}")
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    loss, grad = out["loss"], out["grad"]
    log(f"[reparam/pose_step] loss {loss.item():.6g} grad {grad.tolist()} {step_s:.4f} s/step "
        f"({REPARAM_BATCH / step_s:.4f} renders/s), peak {peak:.3f} GiB")
    if (tuple(grad.shape) != (3,) or not torch.isfinite(grad).all() or grad.abs().max() == 0
            or not torch.isfinite(loss)):
        raise AssertionError("reparam: the translation gradient is not a finite nonzero (3,)")
    return res, counts


FILM_ODD = 500  # the odd film: divides into neither 128 nor 16
FILM_CHECK = (200, 120)  # odd_film's CUDA-against-CPU film
FILM_BANDS = 4
QUAD_SIZE, QUAD_VARIANTS, QUAD_NODES = 100, 64, (16, 32)
PARALLEL_FRAMES = 8
BLOCKER_VARIANTS, BLOCKER_BATCH = 8192, 2048


def _image_mean(img, aux):
    return img.mean(dim=(1, 2, 3))


def odd_film_phase(dev, seeds) -> tuple[dict, dict]:
    """The main shape (vocalfold resolution 24, 1440 faces, 16 variants, 2
    bounces, spp 1, the analytic projector) at a FILM_ODD^2 film, which
    takes the permutation route of `rays.camera_rays_tiled`: its 128x16
    blocks end in partial blocks, so the 2048-ray kernel tiles straddle
    them, and the last ray tile is padded.  Every B1 and B3 launch of one
    forward batch replayed against the plain versions (plain on 2
    variants, 0 rays off, each replay over the padded ray count); CUDA
    against the CPU plain path at FILM_CHECK with the beam gradient
    (`reference_phase`); a counted forward (B1 5, B3 1, no other) with
    renders/s and peak memory; a pattern step.  Returns (the replays, the
    forward's launches)."""
    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda.intersect_kernel import RAY_TILE  # noqa: PLC0415

    bridge, randomize, beams, cfg = main_path.build_shape("main", dev, FILM_ODD)
    n_pix = FILM_ODD * FILM_ODD
    padded = -(-n_pix // RAY_TILE) * RAY_TILE
    log(f"[odd_film/kernels] {BATCH} variants x {FILM_ODD}x{FILM_ODD} rays ({n_pix}, padded to "
        f"{padded}), {len(bridge._faces)} faces, spp {cfg.spp}, {cfg.max_bounces} bounces")
    res = kernel_phase("odd_film", lambda: main_path.render_batch(bridge, randomize, beams, seeds,
                                                                  cfg), None, 2)
    kernels = sorted({r["kernel"] for r in res.values()})
    off = sum(r["mismatched"] for r in res.values())
    short = [case for case, r in res.items() if r["rays"] != padded]
    if kernels != sorted([B1, B3]) or off or short:
        raise AssertionError(f"odd_film: replays of {kernels}, {off} rays off, {short} not over "
                             f"the padded {padded} rays")
    log(f"[odd_film/kernels] {len(res)} replays, 0 rays off, each over {padded} rays "
        f"({padded - n_pix} of the last tile padded)")
    log("[odd_film/reference]")
    reference_phase("odd_film", bridge, randomize, beams, dev,
                    cfg.replace(width=FILM_CHECK[0], height=FILM_CHECK[1]), grad=("beams",))
    counts = forward_phase("odd_film", bridge, randomize, beams, seeds, cfg, (B1, B3))
    if counts[B1] != 5 or counts[B3] != 1:
        raise AssertionError(f"odd_film: a forward launched {counts}, not B1 5 and B3 1")
    pattern_phase("odd_film", bridge, randomize, beams, seeds, cfg, dev)
    return res, counts


def bands_phase(dev, seeds) -> dict:
    """The main shape's film rendered in FILM_BANDS horizontal bands
    (`render_rgb(film_y0=, film_full_height=)`) against the whole film, at
    pixel centres and one bounce, where nothing is drawn: the 512^2 film in
    bands of 128 rows (the arithmetic route) and the FILM_ODD^2 film in
    bands of 125 (the permutation route; its bands' ray tiles group other
    pixels than the whole film's).  Each pixel within 1e-6 relative (a
    black pixel exactly); counted (B1 only: one bounce).  Returns the
    launches."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.render import render_rgb  # noqa: PLC0415

    bridge, randomize, beams = main_path.build(dev)
    out = {}

    def drive():
        with torch.no_grad():
            scene = main_path.scene_batch(bridge, randomize, beams,
                                          main_path.generators(seeds, dev))
            for size in (SIZE, FILM_ODD):
                cfg = main_path.bench_config(size=size, bounces=1)
                band = size // FILM_BANDS
                whole = render_rgb(scene, None, cfg)
                parts = torch.cat([render_rgb(scene, None, cfg.replace(height=band), film_y0=y0,
                                              film_full_height=size)
                                   for y0 in range(0, size, band)], dim=1)
                out[size] = whole, parts

    counts = count_launches(drive)
    for size, (whole, parts) in out.items():
        diff = (parts - whole).abs()
        bad = int((diff > 1e-6 * whole.abs()).any(-1).sum())
        same = float((parts == whole).all(-1).float().mean())
        rel = float((diff / whole.abs().clamp(min=1e-30)).max())
        log(f"[bands] {size}x{size} in {FILM_BANDS} bands of {size // FILM_BANDS} rows, "
            f"{BATCH} variants: {same:.6f} of pixels bit for bit, max relative difference "
            f"{rel:.3g}, {bad} pixels beyond 1e-6; image mean {whole.mean().item():.6g}")
        if bad or not torch.isfinite(whole).all() or whole.max() <= 0:
            raise AssertionError(f"bands: {bad} pixels of the {size}^2 bands differ from the film")
    log(f"[bands] launches {counts}")
    check_launches("bands", counts, (B1,))
    return counts


def quadrature_phase(dev) -> dict:
    """The quadrature witness (render/quadrature.py, brute force, no
    kernel) against the path tracer on the card, at QUAD_SIZE^2 with
    row-major `camera_rays` (primary rays on B1 from the camera, shadow
    rays on B1, bounces on B3): hello_world without rotation and
    cornell_like, each randomized once on the card; at one vertex within
    1e-5 absolute per pixel (both compute the same integral, nothing
    drawn); at 2 bounces on cornell_like the mean of QUAD_VARIANTS
    path-tracer variants against the quadrature at QUAD_NODES (n_mu,
    n_phi) within the noise, as tests/test_transport_quadrature.py holds
    it: the mean images within 4 standard errors of the film's mean plus
    2e-3, the per-pixel RMSE within 1.6 times the mean per-pixel standard
    error plus 2e-3.  Counted (B1 and B3).  Returns the launches."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.assets import scenes  # noqa: PLC0415
    from fireflies_tpu_torch.render import RenderConfig, SceneBridge  # noqa: PLC0415
    from fireflies_tpu_torch.render.pathtracer import trace_rays  # noqa: PLC0415
    from fireflies_tpu_torch.render.quadrature import radiance_quadrature  # noqa: PLC0415
    from fireflies_tpu_torch.render.rays import camera_rays  # noqa: PLC0415

    size = QUAD_SIZE
    failed = []

    def drive():
        for name, build in (("hello_world", lambda: scenes.hello_world(randomize_rotation=False)),
                            ("cornell_like", scenes.cornell_like)):
            scene, kw = build()
            bridge = SceneBridge(scene, **kw)
            params = scene.compile(device=dev)(torch.Generator(device=dev).manual_seed(7), 0)
            rs = bridge.assemble([params])
            o, d = camera_rays(rs.camera, size, size)
            cam = rs.camera.to_world[:, :3, 3]
            t0 = time.perf_counter()
            with torch.no_grad():
                pt = trace_rays(rs, o, d, None, RenderConfig(width=size, height=size,
                                                             max_bounces=1), primary_origin=cam)
                q = radiance_quadrature(rs, o, d, max_bounces=1)
            torch.cuda.synchronize()
            err = float((pt - q).abs().max())
            log(f"[quadrature/{name}] {size}x{size}, {len(bridge._faces)} faces, one vertex: "
                f"max |path tracer - quadrature| {err:.3g} (image max {q.max().item():.4g}); "
                f"{time.perf_counter() - t0:.2f} s")
            if err > 1e-5 or not q.max() > 0:
                failed.append(f"{name} at one vertex")
            if name != "cornell_like":
                continue
            t0 = time.perf_counter()
            n_mu, n_phi = QUAD_NODES
            with torch.no_grad():
                rs_k = bridge.assemble([params] * QUAD_VARIANTS)
                pts = trace_rays(rs_k, o.expand(QUAD_VARIANTS, -1, -1),
                                 d.expand(QUAD_VARIANTS, -1, -1),
                                 main_path.generators(range(QUAD_VARIANTS), dev),
                                 RenderConfig(width=size, height=size, max_bounces=2),
                                 primary_origin=cam.expand(QUAD_VARIANTS, -1))
                torch.cuda.synchronize()
                pt_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                q2 = radiance_quadrature(rs, o, d, max_bounces=2, n_mu=n_mu, n_phi=n_phi)[0]
                torch.cuda.synchronize()
                q_s = time.perf_counter() - t0
            pt_mean = pts.mean(0)
            mean_sem = float((pts.std(0) / QUAD_VARIANTS ** 0.5).mean())
            rmse = float(((pt_mean - q2) ** 2).mean().sqrt())
            d_mean = abs(float(pt_mean.mean() - q2.mean()))
            log(f"[quadrature/{name}] 2 bounces: the mean of {QUAD_VARIANTS} path-tracer "
                f"variants ({pt_s:.2f} s) against the quadrature at n_mu {n_mu}, n_phi {n_phi} "
                f"({q_s:.2f} s): image means {pt_mean.mean().item():.6g} and "
                f"{q2.mean().item():.6g}; per-pixel RMSE {rmse:.4g} against the mean per-pixel "
                f"standard error {mean_sem:.4g} (ratio {rmse / mean_sem:.3f})")
            if (d_mean >= 4 * mean_sem / q2.numel() ** 0.5 + 2e-3
                    or rmse >= 1.6 * mean_sem + 2e-3 or not torch.isfinite(pts).all()):
                failed.append(f"{name} at 2 bounces")

    counts = count_launches(drive)
    log(f"[quadrature] launches {counts}")
    if failed:
        raise AssertionError(f"quadrature: the path tracer misses the witness: {failed}")
    check_launches("quadrature", counts, (B1, B3))
    return counts


def parallel_phase(dev, seeds) -> dict:
    """`parallel/` at world size 1 over NCCL (the process group from a
    FileStore in a temporary directory), on the main shape at 512^2:
    `psum_grad_step` over `main_path.variant_loss` (the mean image, 16
    variants from `shard_keys`) against the one-process loss and beam
    gradient of the same generators (1e-6 and 1e-5 relative);
    `render_tile_parallel` (one band) equal to `render_rgb` with the same
    generators; `all_gather_frames` the identity; then a counted
    `datagen.generate_dataset_parallel` of PARALLEL_FRAMES accepted frames
    (`main_path.datagen_batch`, 8 a dispatch) written to a temporary
    directory (B1 and B3).  At world size 1 the gathers and means return
    before any collective, so only the group's start and the farm's
    broadcast reach NCCL; the 2-rank gloo tests exercise the rest.  One
    card shows no scaling.  Returns the counted run's launches."""
    import os  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    from fireflies_tpu_torch import datagen, main_path, parallel  # noqa: PLC0415
    from fireflies_tpu_torch.render import render_rgb  # noqa: PLC0415
    from fireflies_tpu_torch.utils.seeds import step_seeds  # noqa: PLC0415

    bridge, randomize, beams, cfg = main_path.build_shape("main", dev, SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.init_distributed(0, 1, dev, store_path=os.path.join(tmp, "store"))
        try:
            mesh = parallel.make_mesh(1, device=dev)
            log(f"[parallel] backend {dist.get_backend()}, world size {dist.get_world_size()}, "
                f"mesh {mesh.shape} on {mesh.device}; {time.perf_counter() - t0:.2f} s")
            loss_fn = main_path.variant_loss(bridge, randomize, cfg, _image_mean)
            step = parallel.psum_grad_step(lambda rays, g: loss_fn(rays, g, 0), mesh)
            loss, grad = step(beams, parallel.shard_keys(mesh, 0, BATCH))
            leaf = beams.detach().requires_grad_(True)
            ref = loss_fn(leaf, main_path.generators(step_seeds(0, 0, BATCH), dev), 0).mean()
            ref.backward()
            loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
            g_rel = float((grad - leaf.grad).norm() / leaf.grad.norm())
            log(f"[parallel/psum_grad_step] {BATCH} variants: loss {loss.item():.8g} against "
                f"{ref.item():.8g} ({loss_rel:.3g} relative), beam gradient {g_rel:.3g} "
                f"relative L2")
            tiles = parallel.make_mesh(axis_name=parallel.TILE_AXIS, device=dev)
            with torch.no_grad():
                scene = main_path.scene_batch(bridge, randomize, beams,
                                              main_path.generators(seeds, dev))
                gens = [s + 100 for s in seeds]
                img_t = parallel.render_tile_parallel(scene, main_path.generators(gens, dev),
                                                      cfg, tiles)
                img = render_rgb(scene, main_path.generators(gens, dev), cfg)
                frames = parallel.all_gather_frames(mesh, img)
            same_t, same_f = torch.equal(img_t, img), torch.equal(frames, img)
            log(f"[parallel/render_tile_parallel] {tuple(img.shape)}: equal to render_rgb "
                f"{same_t}; all_gather_frames the identity {same_f}")
            if not (loss_rel <= 1e-6 and g_rel <= 1e-5 and leaf.grad.abs().max() > 0
                    and same_t and same_f):
                raise AssertionError("parallel: world size 1 differs from one process")
            fn = main_path.datagen_batch(bridge, randomize, beams, cfg)
            out = {}
            t0 = time.perf_counter()
            counts = count_launches(lambda: out.update(n=datagen.generate_dataset_parallel(
                fn, PARALLEL_FRAMES, os.path.join(tmp, "farm"), 0, mesh, per_device=8)))
            farm_s = time.perf_counter() - t0
            written = len(os.listdir(os.path.join(tmp, "farm", "images")))
            log(f"[parallel/generate_dataset_parallel] {out['n']} frames ({written} PNG images) "
                f"in {farm_s:.3f} s; launches {counts}")
            if out["n"] != PARALLEL_FRAMES or written != PARALLEL_FRAMES:
                raise AssertionError("parallel: generate_dataset_parallel wrote the wrong count")
            check_launches("parallel", counts, (B1, B3))
        finally:
            dist.destroy_process_group()
    return counts


def blocker_phase(dev) -> None:
    """The warped-area gradient on the scene that needs it: the blocker
    scene (`main_path.blocker_scene`, tests/test_mb3_grad_nan.py's, 8x8,
    spp 2, max_bounces 3, reparam with reparam_indirect over 2 bounces):
    d(mean red)/d(dx) at dx = 1 from the warped render, and the central
    difference of the plain render at 1 +- 0.25 with the same generators,
    over BLOCKER_VARIANTS variants in batches of BLOCKER_BATCH
    (`main_path.blocker_gradient_samples`), each with its standard error;
    printed beside the reference's note (0.046 +- 0.004).  Fails on a
    non-finite sample, when the two means differ by more than twice their
    combined standard error, or when the gradient is not above four of its
    standard errors (without the warped bounces it is exactly 0)."""
    import numpy as np  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    t0 = time.perf_counter()
    grads, fds = [], []
    for k in range(BLOCKER_VARIANTS // BLOCKER_BATCH):
        g, f = main_path.blocker_gradient_samples(BLOCKER_BATCH, seed0=1000 + k * BLOCKER_BATCH,
                                                  device=dev)
        grads.append(g)
        fds.append(f)
    g, f = np.concatenate(grads), np.concatenate(fds)
    n = len(g)
    se_g, se_f = g.std(ddof=1) / n ** 0.5, f.std(ddof=1) / n ** 0.5
    z = (g.mean() - f.mean()) / math.hypot(se_g, se_f)
    log(f"[blocker] {n} variants: warped-area gradient {g.mean():.6g} +- {se_g:.3g}, "
        f"finite difference {f.mean():.6g} +- {se_f:.3g} (difference {z:+.2f} combined standard "
        f"errors; the reference's note: 0.046 +- 0.004); {time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(g).all() and np.isfinite(f).all()):
        raise AssertionError("blocker: a non-finite gradient sample")
    if abs(z) > 2 or g.mean() <= 4 * se_g:
        raise AssertionError(f"blocker: the warped-area gradient {g.mean():.6g} +- {se_g:.3g} "
                             f"against the finite difference {f.mean():.6g} +- {se_f:.3g}")


def films_phase(dev, seeds) -> tuple[dict, dict]:
    """odd_film, bands, quadrature, parallel and blocker, each timed.  Returns
    (odd_film's replays, the launches of each counted path)."""
    counts = {}
    t0 = time.perf_counter()
    res, counts["odd_film"] = odd_film_phase(dev, seeds)
    log(f"[odd_film] {time.perf_counter() - t0:.1f} s")
    for tag, phase in (("bands", bands_phase), ("quadrature", quadrature_phase),
                       ("parallel", parallel_phase)):
        t0 = time.perf_counter()
        counts[tag] = phase(dev, seeds) if tag != "quadrature" else phase(dev)
        log(f"[{tag}] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    blocker_phase(dev)
    log(f"[blocker] {time.perf_counter() - t0:.1f} s")
    return res, counts



SCENE_FILE_PATHS = ("xml", "yaml")
LOAD_REPEATS = 3


def _load_scene_file(tag: str, tmp: str):
    """(scene, bridge_kwargs, load seconds of each repeat) of a scene file
    path: `main_path.xml_scene` (tools/parity_scenes/vocalfold.xml), or the
    `yaml` shape's files written into `tmp` once and loaded by
    `main_path.yaml_scene`; only the loads are timed."""
    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    path = main_path.write_yaml_scene(tmp) if tag == "yaml" else main_path.VOCALFOLD_XML
    load = main_path.yaml_scene if tag == "yaml" else main_path.xml_scene
    times = []
    for _ in range(LOAD_REPEATS):
        t0 = time.perf_counter()
        scene, kw = load(path)
        times.append(time.perf_counter() - t0)
    return scene, kw, times


def _rig(seed: int = 0):
    """A synthetic 3-joint skinning rig (numpy, float32): rest vertices
    (12, 3) along +y, a nearest-vertex joint regressor (3, 12), parents
    (-1, 0, 1), hard skin weights by segment (12, 3), pose blend shapes
    (18, 12, 3) and a pose (3, 3)."""
    import numpy as np  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    v, j = 12, 3
    rest = np.stack([rng.uniform(-0.1, 0.1, v), np.linspace(0, 3.0, v), np.zeros(v)],
                    -1).astype(np.float32)
    j_reg = np.zeros((j, v), np.float32)
    for ji, y in enumerate((0.0, 1.0, 2.0)):
        j_reg[ji, int(np.argmin(np.abs(rest[:, 1] - y)))] = 1.0
    weights = np.zeros((v, j), np.float32)
    weights[np.arange(v), np.minimum(rest[:, 1].astype(int), 2)] = 1.0
    posedirs = rng.normal(0, 0.001, (9 * (j - 1), v, 3)).astype(np.float32)
    pose = rng.normal(0, 0.4, (j, 3)).astype(np.float32)
    return rest, j_reg, np.array([-1, 0, 1]), weights, posedirs, pose


def scene_modules_check(dev) -> None:
    """The scene modules' tensor math, CUDA against the CPU on the same
    inputs: `entity.shape_model.lbs` on `_rig` (vertices within 1e-5 of
    their largest magnitude) and its pose gradient (1e-4 relative L2);
    `rand_perlin_2d` with injected angles at every candidate resolution
    of a 256^2 texture, and `NoiseTextureLerpSampler.texture` from one set
    of draws (1e-5 absolute)."""
    import numpy as np  # noqa: PLC0415
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415
    from fireflies_tpu_torch.entity.shape_model import lbs  # noqa: PLC0415
    from fireflies_tpu_torch.sampling import noise_texture_lerp as noise  # noqa: PLC0415

    rest, j_reg, parents, weights, posedirs, pose = _rig()
    w_out = np.random.default_rng(1).normal(size=rest.shape).astype(np.float32)

    def skin(device):
        q = torch.tensor(pose, device=device, requires_grad=True)
        out = lbs(torch.tensor(rest, device=device), q, torch.tensor(j_reg, device=device),
                  parents, torch.tensor(weights, device=device),
                  torch.tensor(posedirs, device=device))
        (out * torch.tensor(w_out, device=device)).sum().backward()
        return out.detach().cpu(), q.grad.cpu()

    (v_k, g_k), (v_p, g_p) = skin(dev), skin(torch.device("cpu"))
    v_err = float((v_k - v_p).abs().max() / v_p.abs().max())
    g_err = float((g_k - g_p).norm() / g_p.norm())
    sampler = noise.NoiseTextureLerpSampler.create(*main_path.NOISE_COLORS,
                                                   texture_shape=main_path.NOISE_TEXTURE)
    rng = np.random.default_rng(2)
    angles = [(2 * np.pi * rng.random((r + 1, r + 1))).astype(np.float32)
              for r in sampler.resolutions()]
    layer_err = max(float((noise.rand_perlin_2d(None, sampler.texture_shape, (r, r), a, dev).cpu()
                           - noise.rand_perlin_2d(None, sampler.texture_shape, (r, r), a, "cpu")
                           ).abs().max()) for r, a in zip(sampler.resolutions(), angles))
    tex_k, tex_p = (sampler.texture(2, 3, 0.8, angles, d).cpu() for d in (dev, "cpu"))
    tex_err = float((tex_k - tex_p).abs().max())
    log(f"[scene_files/modules] lbs on a 3-joint rig, CUDA against CPU: vertices {v_err:.3g} of "
        f"their scale, pose gradient {g_err:.3g} relative L2; rand_perlin_2d at resolutions "
        f"{sampler.resolutions()} on {sampler.texture_shape}: max |diff| {layer_err:.3g}; the "
        f"sampler's texture {tuple(tex_k.shape)}: {tex_err:.3g}")
    if not (torch.isfinite(v_k).all() and g_p.abs().max() > 0 and v_err <= 1e-5
            and g_err <= 1e-4 and layer_err <= 1e-5 and tex_err <= 1e-5):
        raise AssertionError("scene_files: lbs or the Perlin noise disagrees with the CPU")


def scene_files_phase(dev, seeds, smi: str) -> tuple[dict, dict]:
    """The two paths that load the vocalfold scene from a file
    (`main_path.BUILDERS`): `xml` (tools/parity_scenes/vocalfold.xml
    through `scene_from_mitsuba_xml`, 1440 faces, the projector and
    examples/vocalfold_scene.py's randomization added after loading) and
    `yaml` (a description written by `save_scene_description` and read by
    `load_scene`, the fold animated from OBJ frames, a 256^2 Perlin texture
    on the mucosa; 1536 faces).  For each: the host seconds of loading
    (LOAD_REPEATS loads); every B1 and B3 launch of one forward batch
    replayed against the plain versions (plain on 2 variants, 0 rays off);
    CUDA against the CPU plain path at 128x32 with the beam gradient
    (`reference_phase`); a counted forward (B1 = 5, B3 = 1, no other) with
    renders/s and peak memory; one pattern step.  Then
    `scene_modules_check`.  Returns (the replays, each path's forward
    launches)."""
    import tempfile  # noqa: PLC0415

    from fireflies_tpu_torch import main_path  # noqa: PLC0415

    res_all, counts_by_path = {}, {}
    for tag in SCENE_FILE_PATHS:
        t_path = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            scene, kw, load_s = _load_scene_file(tag, tmp)
        bridge, randomize, beams, cfg = main_path.shape_from_scene(scene, kw, dev, SIZE)
        log(f"[{tag}/load] {statistics.median(load_s):.4f} s (loads {[round(t, 4) for t in load_s]}); "
            f"{len(bridge._faces)} faces, meshes {[m.name() for m in scene.meshes()]}, binding "
            f"{scene.mesh_material_binding()}, maps on {sorted(bridge._texture_mats)}")
        res = kernel_phase(tag, lambda: main_path.render_batch(bridge, randomize, beams, seeds,
                                                               cfg), None, 2, replay_any=False,
                           time_plain=False)
        kernels = sorted({r["kernel"] for r in res.values()})
        off = sum(r["mismatched"] for r in res.values())
        if kernels != sorted([B1, B3]) or off:
            raise AssertionError(f"{tag}: replays of {kernels}, {off} rays off")
        log(f"[{tag}/reference]")
        reference_phase(tag, bridge, randomize, beams, dev, cfg.replace(width=128, height=32),
                        grad=("beams",))
        counts = forward_phase(tag, bridge, randomize, beams, seeds, cfg, (B1, B3))
        if counts[B1] != 5 or counts[B3] != 1:
            raise AssertionError(f"{tag}: a forward launched {counts}, not B1 5 and B3 1")
        pattern_phase(tag, bridge, randomize, beams, seeds, cfg, dev)
        log(f"[{tag}] {smi}: load {statistics.median(load_s):.4f} s; {time.perf_counter() - t_path:.1f} s")
        res_all.update(res)
        counts_by_path[tag] = counts
    scene_modules_check(dev)
    return res_all, counts_by_path


def bench_phase() -> list[dict]:
    """`bench.measure` for the headline row, the texture row, the reference
    shape, and the face-table route's rows (the reference shape unshared
    with static_geom=0, smooth=1, and grad_mode="pose_soft"), with few
    repeats and trials; prints each line."""
    from fireflies_tpu_torch import bench  # noqa: PLC0415

    rows = [dict(), dict(analytic=0), dict(resolution=75, spp=4, coherent=1, shared=1),
            dict(resolution=75, spp=4, coherent=1, static_geom=0), dict(smooth=1),
            dict(grad_mode="pose_soft")]
    lines = []
    for row in rows:
        t0 = time.perf_counter()
        line = bench.measure(**row, repeats=BENCH_REPEATS, trials=BENCH_TRIALS)
        log(f"[bench] {row}: {time.perf_counter() - t0:.1f} s")
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def optimize_phase(dev) -> dict:
    """The pattern optimizer (`optim.optimize_pattern_through_render` over
    `main_path.variant_loss`) on the main shape at full width: 16 variants
    a step at 512x512, spp 1, 2 bounces, 144 uniform beams, the analytic
    projector, `dot_coverage_objective(1)`, lr 5e-3, fov 30, respawn on,
    OPT_STEPS steps, with the counters set to 0 just before and read just
    after: B1 and B3 launched and no other.  Each step's loss, s/step of
    steps 2 on (the first loads the backward's kernels), peak memory.  The
    beams must stay finite and unit-norm (1e-5), and step 1's loss must
    equal one direct batched render plus objective at the same seeds and
    step (1e-5 relative).  Then `optimize_point_pattern` at the reference
    defaults (500 points, 512^2, 200 steps): first and last loss, s/step;
    the last must be below the first.  Returns the optimizer's launches."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path, optim  # noqa: PLC0415
    from fireflies_tpu_torch.render import render_rgb  # noqa: PLC0415
    from fireflies_tpu_torch.utils.seeds import step_generators  # noqa: PLC0415

    bridge, randomize, beams, cfg = main_path.build_shape("main", dev, SIZE)
    objective = optim.dot_coverage_objective(1)
    loss_fn = main_path.variant_loss(bridge, randomize, cfg, objective)
    starts = []

    def timed_loss(rays, gens, step):
        torch.cuda.synchronize()  # the previous step has ended
        starts.append(time.perf_counter())
        return loss_fn(rays, gens, step)

    torch.cuda.reset_peak_memory_stats(dev)
    res = {}

    def drive():
        res["opt"] = optim.optimize_pattern_through_render(
            timed_loss, beams, seed=OPT_SEED, steps=OPT_STEPS, batch=BATCH, learning_rate=5e-3,
            fov_deg=main_path.PROJECTOR_FOV, respawn_oob=True)

    launches = count_launches(drive)
    end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rays, losses = res["opt"].rays, res["opt"].losses.tolist()
    step_s = (end - starts[1]) / (OPT_STEPS - 1)
    log(f"[optimize] {OPT_STEPS} steps of {BATCH} variants: losses {losses}; {step_s:.4f} s/step "
        f"(steps 2-{OPT_STEPS}; step 1 {starts[1] - starts[0]:.4f} s), peak {peak:.3f} GiB; "
        f"launches {launches}")
    check_launches("optimize", launches, (B1, B3))
    norm_err = float((rays.norm(dim=-1) - 1).abs().max())
    if not (torch.isfinite(rays).all() and norm_err <= 1e-5 and tuple(rays.shape) == (144, 3)):
        raise AssertionError(f"optimize: beams not finite unit vectors (max |1 - |d|| {norm_err})")
    if not all(map(math.isfinite, losses)):
        raise AssertionError("optimize: a step's loss is not finite")
    with torch.no_grad():
        gens = step_generators(OPT_SEED, 0, BATCH + 1, dev)[:BATCH]
        scene = main_path.scene_batch(bridge, randomize, beams, gens, steps=[0] * BATCH)
        direct = float(objective(render_rgb(scene, gens, cfg)).mean())
    rel = abs(losses[0] - direct) / abs(direct)
    log(f"  step 1's loss {losses[0]!r} against the direct batched render's {direct!r}: "
        f"{rel:.3g} relative")
    if rel > 1e-5:
        raise AssertionError("optimize: step 1's loss differs from the direct render's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = optim.optimize_point_pattern(seed=OPT_SEED, device=dev)
    first, last = float(pts.losses[0]), float(pts.losses[-1])
    point_s = (time.perf_counter() - t0) / len(pts.losses)
    log(f"[optimize/points] {pts.points.shape[0]} points, 512x512, {len(pts.losses)} steps: loss "
        f"{first:.6g} -> {last:.6g}, {point_s:.5f} s/step")
    if not (last < first and torch.isfinite(pts.points).all()):
        raise AssertionError("optimize_point_pattern did not lower its loss")
    return launches


def datagen_phase(dev) -> tuple[dict, dict]:
    """The dataset farm's AOVs (`render/integrators.py`) on the main shape
    at a 128x32 film, 2 variants, on the card against the CPU path (plain
    versions): `render_segmentation` equal on every pixel but t-ties
    (depths within 1e-5), at most 1e-4 of the pixels; `render_depth`
    within 1e-5 relative where both hit; `render_from_laser` (the 144 beams
    from the projector, B3) with equal valid masks and depth within 1e-5.
    Then one `main_path.datagen_batch` dispatch (the farm's render at spp 4
    on the face-table route, blur, clip, segmentation), counted: B1 and B3
    and no other; then bench's datagen row at its full parameters (512^2,
    spp 4, batch 8, 32 accepted frames), its JSON line printed, counted
    the same way.  Returns (the dispatch's launches, the row's)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import bench, main_path  # noqa: PLC0415
    from fireflies_tpu_torch.projection import laser  # noqa: PLC0415
    from fireflies_tpu_torch.render import RenderConfig, integrators  # noqa: PLC0415

    bridge, randomize, beams = main_path.build(dev)
    cfg = RenderConfig(width=128, height=32, spp=1, max_bounces=1)
    outs = []
    for device in (dev, torch.device("cpu")):
        params = [randomize(torch.Generator(device=dev).manual_seed(s), s) for s in (7, 8)]
        scene = bridge.assemble([{k: v.to(device) for k, v in p.items()} for p in params])
        pose = scene.projector.to_world
        b = beams.to(device)
        lz = integrators.render_from_laser(scene, laser.origin_per_ray(pose, b.shape[0]),
                                           laser.rays_to_world(b, pose), cfg)
        outs.append([x.cpu() for x in (integrators.render_depth(scene, cfg),
                                        integrators.render_segmentation(scene, cfg), *lz)])
    (d_k, s_k, _, z_k, v_k, _), (d_p, s_p, _, z_p, v_p, _) = outs
    both = (d_k > 0) & (d_p > 0)
    d_rel = float(((d_k - d_p).abs() / d_p.clamp(min=1e-30))[both].max())
    differ = s_k != s_p
    tie = (d_k - d_p).abs() <= 1e-5 * d_p.abs()
    z_err = float(((z_k - z_p).abs() / z_p.abs())[v_p].max()) if bool(v_p.any()) else 0.0
    log(f"[datagen/aov] 128x32, 2 variants, CUDA against CPU plain: segmentation "
        f"{int(differ.sum())} of {differ.numel()} pixels differ ({int((differ & ~tie).sum())} off a t-tie), ids "
        f"{torch.unique(s_p).tolist()}; depth max relative {d_rel:.3g} on {int(both.sum())} hit "
        f"pixels; laser {int(v_p.sum())} of {v_p.numel()} beams valid, masks "
        f"{'equal' if torch.equal(v_k, v_p) else 'DIFFER'}, depth max relative {z_err:.3g}")
    if bool((differ & ~tie).any()) or int(differ.sum()) > 1e-4 * differ.numel():
        raise AssertionError("datagen: the CUDA segmentation disagrees with the CPU one")
    if not (bool(both.any()) and d_rel <= 1e-5):
        raise AssertionError("datagen: the CUDA depth disagrees with the CPU one")
    if not (torch.equal(v_k, v_p) and bool(v_p.any()) and z_err <= 1e-5):
        raise AssertionError("datagen: render_from_laser disagrees with the CPU one")

    farm_cfg = RenderConfig(width=SIZE, height=SIZE, spp=4, max_bounces=2)
    fn = main_path.datagen_batch(bridge, randomize, beams, farm_cfg)
    out = {}
    dispatch = count_launches(lambda: out.update(r=fn(list(range(8)), list(range(8)))))
    img, seg = out["r"]
    log(f"[datagen/dispatch] 8 frames at {SIZE}x{SIZE}, spp 4: images {tuple(img.shape)} in "
        f"[{float(img.min()):.4g}, {float(img.max()):.4g}], segmentation ids "
        f"{torch.unique(seg).tolist()}; launches {dispatch}")
    check_launches("datagen", dispatch, (B1, B3))
    if not (torch.isfinite(img).all() and img.max() > 0 and seg.max() > 0):
        raise AssertionError("datagen: the dispatch's frames are empty or not finite")

    t0 = time.perf_counter()
    row = count_launches(lambda: out.update(line=bench.measure_datagen(device=dev)))
    log(f"[bench] datagen row: {time.perf_counter() - t0:.1f} s; launches {row}")
    print(json.dumps(out["line"]), flush=True)
    check_launches("datagen row", row, (B1, B3))
    return dispatch, row


def _unit_forward(tag: str, rays) -> None:
    """Beams (K, 3) on the card, finite, unit (1e-5) and forward (z < 0)."""
    import torch  # noqa: PLC0415

    norm_err = float((rays.norm(dim=-1) - 1).abs().max())
    if not (rays.is_cuda and rays.ndim == 2 and rays.shape[0] > 0 and torch.isfinite(rays).all()
            and norm_err <= 1e-5 and float(rays[:, 2].max()) < 0):
        raise AssertionError(f"{tag}: beams not finite, unit and forward on the card "
                             f"(max |1 - |d|| {norm_err})")


def estimation_phase(dev) -> tuple[dict, dict]:
    """Pattern initialization (`estimation.initialize_laser`) on the main
    shape at full width (vocalfold resolution 24, 1440 faces), projector
    fov `main_path.PROJECTOR_FOV`, `LaserConfig(**EST_CONFIG)` (the
    defaults: 150 beams, 16 depth maps at 256x256):
      1. each of GRID, RANDOM, POISSON and SMARTY once, with every counter
         set to 0 just before and read just after: the beams finite, unit
         (1e-5) and forward (z < 0); SMARTY launches B1 once (its depth
         maps in one batch) and no other kernel, the other modes none; then
         a second SMARTY run's seconds split into depth maps (the variants
         and their render, to the device's end), Bridson (host) and the
         rest; that run's B1 launch replayed through the kernel and its
         plain version (2 variants), timed, with its bounds;
      2. SMARTY on the card against the CPU path (plain versions) on the
         same variants, drawn once on the card, at EST_CHECK's film and
         maps (radii 2-8 px, for more chosen pixels on the small film):
         depth maps with the same hit mask and within 1e-5 relative,
         the radius map within 1e-5 relative, and the beams that
         `laser_from_ndc_points` aims at the card's chosen pixels within
         1e-5 (Bridson between them runs on the host and may fork on an
         ulp of its radius map, so its points are not compared);
      3. `Laser.render_epipolar_lines` of the SMARTY pattern at 256x256 in
         the scene's camera, card against CPU, within 1e-5 of the max;
      4. `optim.optimize_pattern_through_render` from the SMARTY beams, as
         the optimize phase runs it (16 variants at 512x512, 2 bounces, the
         analytic projector, OPT_STEPS steps), counted: B1 and B3 and no
         other kernel, finite losses, unit beams; s/step of steps 2 on and
         peak memory.
    Returns (the replay's results, SMARTY's launches, the optimizer's)."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import main_path, optim  # noqa: PLC0415
    from fireflies_tpu_torch.estimation import LaserConfig, initialize_laser  # noqa: PLC0415
    from fireflies_tpu_torch.estimation import laser_estimation  # noqa: PLC0415
    from fireflies_tpu_torch.projection.camera import Camera  # noqa: PLC0415
    from fireflies_tpu_torch.projection.laser import Laser  # noqa: PLC0415

    cpu = torch.device("cpu")
    fov = main_path.PROJECTOR_FOV
    bridge, randomize, _, cfg = main_path.build_shape("main", dev, SIZE)
    scene = bridge._scene
    config = LaserConfig(**EST_CONFIG)
    log(f"[estimation] main shape ({len(bridge._faces)} faces), projector fov {fov}, {config}")

    # 1. the four modes, counted.
    smarty = {}
    for mode in ("GRID", "RANDOM", "POISSON", "SMARTY"):
        out = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = count_launches(lambda: out.update(laser=initialize_laser(
            scene, bridge, config, mode=mode, projector_fov=fov, device=dev, info=smarty)))
        secs = time.perf_counter() - t0
        rays = out["laser"].local_rays()
        log(f"[estimation/{mode}] {rays.shape[0]} beams in {secs:.4f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        _unit_forward(f"estimation/{mode}", rays)
        if mode == "SMARTY":
            check_launches("estimation/SMARTY", counts, (B1,))
            if counts[B1] != 1:
                raise AssertionError(f"SMARTY's depth maps took {counts[B1]} B1 launches, not 1")
            smarty_rays, smarty_launches = rays, counts
        elif any(counts.values()):
            raise AssertionError(f"estimation/{mode} launched a kernel: {counts}")
    info = {}
    torch.cuda.synchronize()
    replays = kernel_phase("estimation", lambda: initialize_laser(
        scene, bridge, config, mode="SMARTY", projector_fov=fov, device=dev, info=info), None, 2,
        replay_any=False)
    rest = info["total_s"] - info["depth_maps_s"] - info["bridson_s"]
    log(f"[estimation/SMARTY] again: {info['total_s']:.4f} s = depth maps "
        f"{info['depth_maps_s']:.4f} s ({config.n_depthmaps} variants, one render at "
        f"{config.image_size[0]}x{config.image_size[1]}) + Bridson {info['bridson_s']:.4f} s "
        f"(host) + the rest {rest:.4f} s; mean depth {float(info['mean_depth']):.6g}, "
        f"{int(info['chosen'].numel())} chosen pixels, epipolar mask "
        f"{float(info['constraint'].mean()):.4g} of the film")

    # 2. SMARTY on the card against the CPU path on the same variants.
    w, h, n = EST_CHECK
    small = LaserConfig(**dict(EST_CONFIG, n_depthmaps=n, image_size=(w, h), smarty_min_radius=2.0,
                               smarty_max_radius=8.0))
    params = [randomize(torch.Generator(device=dev).manual_seed(100 + i), i) for i in range(n)]
    ref = randomize(torch.Generator(device=dev).manual_seed(0), 0)
    card, host = {}, {}
    for device, run in ((dev, card), (cpu, host)):
        variants = (bridge.assemble([{k: v.to(device) for k, v in p.items()} for p in params]),
                    bridge.assemble([{k: v.to(device) for k, v in ref.items()}]))
        initialize_laser(scene, bridge, small, mode="SMARTY", projector_fov=fov, device=device,
                         variants=variants, info=run)
    d_k, d_p = card["depth_maps"].cpu(), host["depth_maps"]
    hit_equal = torch.equal(d_k > 0, d_p > 0)
    both = (d_k > 0) & (d_p > 0)
    d_rel = float(((d_k - d_p).abs() / d_p.clamp(min=1e-30))[both].max()) if both.any() else 0.0
    r_k, r_p = card["radius_map"].cpu(), host["radius_map"]
    r_rel = float(((r_k - r_p).abs() / r_p).max())
    chosen = card["chosen"]
    beams = [laser_estimation.laser_from_ndc_points(
        run["camera"], run["laser_world"][:3, 3], run["mean_depth"],
        chosen.to(run["laser_world"].device), (h, w)).cpu() for run in (card, host)]
    b_err = float((beams[0] - beams[1]).abs().max()) if chosen.numel() else 0.0
    log(f"[estimation/check] {w}x{h}, {n} maps, CUDA against CPU plain: hit masks "
        f"{'equal' if hit_equal else 'DIFFER'} ({int(both.sum())} hits, "
        f"{int((d_k == d_p).sum())} of {d_p.numel()} depths equal), depth max relative "
        f"{d_rel:.3g}; radius map max relative {r_rel:.3g}; mean depth "
        f"{float(card['mean_depth']):.8g} / {float(host['mean_depth']):.8g}; beams at the card's "
        f"{chosen.numel()} chosen pixels max |difference| {b_err:.3g}; chosen pixels "
        f"{'equal' if torch.equal(chosen.cpu(), host['chosen']) else 'differ (Bridson forked)'}")
    if not (hit_equal and bool(both.any()) and d_rel <= 1e-5):
        raise AssertionError("estimation: the CUDA depth maps disagree with the CPU ones")
    if r_rel > 1e-5:
        raise AssertionError("estimation: the CUDA radius map disagrees with the CPU one")
    if not (chosen.numel() > 0 and b_err <= 1e-5):
        raise AssertionError("estimation: the beams of the chosen pixels disagree")

    # 3. the SMARTY pattern's epipolar lines, card against CPU.
    cam_fov = float(smarty["camera"].fov[0])
    lines = []
    for device in (dev, cpu):
        laser = Laser(scene.projector(), smarty_rays.to(device), fov=fov)
        lines.append(laser.render_epipolar_lines(Camera(scene.camera(), fov=cam_fov,
                                                        device=device),
                                                 EST_LINE_SIGMA, EST_LINE_SIZE).cpu())
    scale = float(lines[1].abs().max())
    l_err = float((lines[0] - lines[1]).abs().max())
    log(f"[estimation/epipolar] {tuple(lines[0].shape)} line splats (sigma {EST_LINE_SIGMA}), "
        f"max {scale:.4g}, CUDA against CPU max |difference| {l_err:.3g}")
    if not (scale > 0 and l_err <= 1e-5 * scale):
        raise AssertionError("estimation: the CUDA epipolar lines disagree with the CPU ones")

    # 4. the optimizer from the SMARTY pattern.
    objective = optim.dot_coverage_objective(1)
    loss_fn = main_path.variant_loss(bridge, randomize, cfg, objective)
    starts, res = [], {}

    def timed_loss(rays, gens, step):
        torch.cuda.synchronize()  # the previous step has ended
        starts.append(time.perf_counter())
        return loss_fn(rays, gens, step)

    def drive():
        res["opt"] = optim.optimize_pattern_through_render(
            timed_loss, smarty_rays, seed=OPT_SEED, steps=OPT_STEPS, batch=BATCH,
            learning_rate=5e-3, fov_deg=fov, respawn_oob=True)

    torch.cuda.reset_peak_memory_stats(dev)
    opt_launches = count_launches(drive)
    end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rays, losses = res["opt"].rays, res["opt"].losses.tolist()
    step_s = (end - starts[1]) / (OPT_STEPS - 1)
    log(f"[estimation/optimize] from {smarty_rays.shape[0]} SMARTY beams, {OPT_STEPS} steps of "
        f"{BATCH} variants at {SIZE}x{SIZE}: losses {losses}; {step_s:.4f} s/step (steps "
        f"2-{OPT_STEPS}; step 1 {starts[1] - starts[0]:.4f} s), peak {peak:.3f} GiB; launches "
        f"{ {k: v for k, v in opt_launches.items() if v} }")
    check_launches("estimation/optimize", opt_launches, (B1, B3))
    _unit_forward("estimation/optimize", rays)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("estimation/optimize: a step's loss is not finite")
    return replays, smarty_launches, opt_launches


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
    reference shapes (`perf_probe.mxu_scenes`: 16 variants, 512x512,
    jittered as the paths cast them, the origin the camera): once with
    t_max = 1e30, once with a per-ray t_max of each variant's median hit
    distance times 0.9-1.1 (`perf_probe.mxu_drive`), with X1's counter set to
    0 just before and read just after.  The per-ray result must be the
    first one cut after the scan.  Each launch is replayed through the
    kernel and its plain version (first 2 variants): the kernel's tensor
    cores only filter the pairs and it tests those that pass as the plain
    version does, so t and prim must equal the plain version's bit for bit
    (0 rays differ, max |dt| 0).  Replayed as any-hit (the same walk) the
    kernel must give the closest-hit replay's outputs.  X1's prims are held
    against B6's (`intersect_shared_packed`, 64-face clusters front to
    back) on the same rays: at most 1e-3 of the live rays may differ, since
    the two tests round edges differently.  Times of X1, its plain version
    (on the t_max = 1e30 launches) and B6, and X1's bounds
    (`perf_probe.mxu_bounds`: tested and least pairs, the FP32 pipe, the
    special-function units and the tensor cores, and with d' on the FP32
    pipe).  Returns X1's entry of the kernels line."""
    import torch  # noqa: PLC0415

    from fireflies_tpu_torch import perf_probe  # noqa: PLC0415
    from fireflies_tpu_torch.experiments import intersect_mxu as mx  # noqa: PLC0415
    from fireflies_tpu_torch.perf_probe import OPS_PER_PAIR, cuda_ms  # noqa: PLC0415
    from fireflies_tpu_torch.render.cuda import intersect_kernel as ik  # noqa: PLC0415

    scenes = perf_probe.mxu_scenes(dev, SIZE, BATCH)
    torch.cuda.synchronize()
    mx.KERNEL.launches = 0
    outs, recorded = perf_probe.mxu_drive(scenes)
    torch.cuda.synchronize()
    launches = mx.KERNEL.launches
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
            rec = {**rec, "any_hit": False}
            rec_p = _first(rec, 2)
            out_k = mx.intersect_mxu_packed(**rec)
            plain = mx.intersect_mxu_packed_plain(**rec_p)
            live_p = rec_p["tmax_tiles"] >= 0
            differ = int(((out_k[1][:2] != plain[1]) & live_p).sum())
            max_dt = float((out_k[0][:2] - plain[0]).abs().max())
            for any_hit in (False, True):
                case = f"mxu/{tag}/t_max {cut}/" + ("as-any" if any_hit else "closest")
                if any_hit:
                    again = mx.intersect_mxu_packed(**{**rec, "any_hit": True})
                    if not all(torch.equal(a, b) for a, b in zip(again, out_k)):
                        raise AssertionError(f"{case}: any-hit differs from the closest-hit walk")
                res = {"live": int(live_p.sum()), "differ": differ, "max_abs_err": max_dt}
                log(f"  {case}: {differ} of {res['live']} live rays differ from the plain "
                    f"version, max |dt| {max_dt:.3g}")
                if not (torch.equal(out_k[0][:2], plain[0]) and torch.equal(out_k[1][:2], plain[1])):
                    raise AssertionError(f"{case}: the kernel disagrees with its plain version")
                if not torch.isfinite(out_k[0]).all():
                    raise AssertionError(f"{case}: non-finite t")
                rec_case = {**rec, "any_hit": any_hit}
                res["ms"] = cuda_ms(lambda rec=rec_case: mx.intersect_mxu_packed(**rec), 20)
                line = f"  {case}: kernel {res['ms']:.4f} ms ({BATCH} variants)"
                if cut == "1e30" and not any_hit:
                    res["plain_ms"] = cuda_ms(
                        lambda rec=rec_p: mx.intersect_mxu_packed_plain(**rec), 2)
                    res["b6_ms"] = cuda_ms(b6, 20)
                    line += (f", plain {res['plain_ms']:.4f} ms (2 variants), "
                             f"B6 {res['b6_ms']:.4f} ms")
                tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
                mx.intersect_mxu_packed(**rec_case, tested=tested)
                generic = bound(MXU, rec, 2, tested)
                res.update(pairs=generic["pairs"], listed_pairs=generic["listed_pairs"])
                res["least_pairs"] = perf_probe.least_pairs(rec, *out_k)
                res.update(perf_probe.mxu_bounds(rec, res["pairs"], res["least_pairs"],
                                                 generic["bytes"], tested))
                live = rec["tmax_tiles"] >= 0
                differ6 = int(((out_k[1] != p6) & live).sum())
                same = (out_k[1] == p6) & (p6 >= 0)
                dt = float((out_k[0] - t6).abs()[same].max()) if bool(same.any()) else 0.0
                res.update(b6_differ=differ6, b6_max_dt=dt)
                log(line + f", bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
                    f"{res['bound_pipe']}: FP32 {res['fp32_ms']:.4f}, SFU {res['sfu_ms']:.4f}, "
                    f"tensor {res['tensor_ms']:.4f} ms; {res['pairs']:.4g} pairs tested of "
                    f"{res['listed_pairs']:.4g}; bound / kernel {res['bound_ms'] / res['ms']:.3f}); "
                    f"least {res['least_pairs']:.4g} pairs, {res['least_bound_ms']:.4f} ms (least / "
                    f"kernel {res['least_bound_ms'] / res['ms']:.3f}); with d' on the FP32 pipe "
                    f"bound {res['bound_ms_fp32_dp']:.4f}, least {res['least_bound_ms_fp32_dp']:.4f}"
                    f" ms ({res['least_bound_ms_fp32_dp'] / res['ms']:.3f}); against B6: {differ6} "
                    f"of {int(live.sum())} live rays differ, max |dt| {dt:.3g}")
                if differ6 > 1e-3 * int(live.sum()):
                    raise AssertionError(f"{case}: {differ6} rays differ from B6")
                results[case] = res

    main, ref = results["mxu/main/t_max 1e30/closest"], results["mxu/reference/t_max 1e30/closest"]
    any_hit = results["mxu/main/t_max 1e30/as-any"]
    return {"name": MXU, "route": "cuda", "source": "fireflies_tpu_torch/csrc/intersect_mxu.cu",
            "replaces": "experiments/intersect_mxu.py:253", "path": "mxu", "launches": launches,
            "ops_per_pair": OPS_PER_PAIR[MXU],
            "ops_per_pair_fp32_dp": perf_probe.MXU_OPS_PER_PAIR_FP32,
            "macs_per_pair": perf_probe.MXU_MACS_PER_PAIR,
            "sfu_per_pair": perf_probe.MXU_SFU_PER_PAIR,
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "differ": sum(r["differ"] for r in results.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "plain_variants": 2,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_pipe": main["bound_pipe"], "fp32_ms": main["fp32_ms"],
            "sfu_ms": main["sfu_ms"], "tensor_ms": main["tensor_ms"],
            "bound_ms_fp32_dp": main["bound_ms_fp32_dp"],
            "tested_pairs": main["pairs"], "listed_pairs": main["listed_pairs"],
            "least_pairs": main["least_pairs"], "least_bound_ms": main["least_bound_ms"],
            "least_bound_ms_fp32_dp": main["least_bound_ms_fp32_dp"],
            "library_ms": None, "any_hit_ms": any_hit["ms"],
            "any_hit_bound_ms": any_hit["bound_ms"], "b6_ms": main["b6_ms"],
            "reference_ms": ref["ms"], "reference_plain_ms": ref["plain_ms"],
            "reference_bound_ms": ref["bound_ms"], "reference_b6_ms": ref["b6_ms"],
            "reference_tested_pairs": ref["pairs"], "reference_least_pairs": ref["least_pairs"],
            "reference_least_bound_ms": ref["least_bound_ms"],
            "reference_least_bound_ms_fp32_dp": ref["least_bound_ms_fp32_dp"]}


SIZE = 512
BATCH = 16
C2_VARIANTS = 4
FIRST = {"closest": 1, "any": 1}  # kernel_phase: replay the first launch of each mode
OPT_SEED, OPT_STEPS = 0, 3
BENCH_REPEATS, BENCH_TRIALS = 3, 2
EST_CONFIG: dict = {}  # estimation: LaserConfig's defaults (150 beams, 16 maps, 256x256)
EST_CHECK = (128, 32, 4)  # estimation: the CPU comparison's film (W, H) and maps
EST_LINE_SIGMA, EST_LINE_SIZE = 10.0, (256, 256)  # estimation: the epipolar lines
MXU = "intersect_mxu_shared"
B1, B3 = "intersect_shared_culled", "intersect_general"
B2, B4 = "intersect_stream_culled", "intersect_stream_general_culled"
B5 = "intersect_general_culled"
B6, B7S, B7G = "intersect_shared", "intersect_stream", "intersect_stream_general"
# name: (entry point's source, the kernel body it instantiates, the TPU kernel)
SOURCES = {
    B1: ("fireflies_tpu_torch/csrc/intersect_shared_culled.cu",
         "fireflies_tpu_torch/csrc/intersect_shared.cuh",
         "fireflies_tpu/render/pallas/intersect_culled.py:700"),
    B3: ("fireflies_tpu_torch/csrc/intersect_general.cu",
         "fireflies_tpu_torch/csrc/intersect_general.cuh",
         "fireflies_tpu/render/pallas/intersect_kernel.py:602"),
    B2: ("fireflies_tpu_torch/csrc/intersect_stream_culled.cu",
         "fireflies_tpu_torch/csrc/intersect_shared.cuh",
         "fireflies_tpu/render/pallas/intersect_stream.py:644"),
    B4: ("fireflies_tpu_torch/csrc/intersect_stream_general_culled.cu",
         "fireflies_tpu_torch/csrc/intersect_stream.cuh",
         "fireflies_tpu/render/pallas/intersect_stream.py:1097"),
    B5: ("fireflies_tpu_torch/csrc/intersect_general_culled.cu",
         "fireflies_tpu_torch/csrc/intersect_general.cuh",
         "fireflies_tpu/render/pallas/intersect_culled.py:465"),
    B6: ("fireflies_tpu_torch/csrc/intersect_shared.cu",
         "fireflies_tpu_torch/csrc/intersect_shared.cuh",
         "fireflies_tpu/render/pallas/intersect_kernel.py:522"),
    B7S: ("fireflies_tpu_torch/csrc/intersect_stream.cu",
          "fireflies_tpu_torch/csrc/intersect_shared.cuh",
          "fireflies_tpu/render/pallas/intersect_stream.py:713"),
    B7G: ("fireflies_tpu_torch/csrc/intersect_stream_general.cu",
          "fireflies_tpu_torch/csrc/intersect_stream.cuh",
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
    from fireflies_tpu_torch.render import RenderConfig  # noqa: PLC0415

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
    kres, launches, kernel_path, path_launches = {}, {}, {}, {}
    # (shape in main_path.SHAPES, kernels of the path, the launches replayed
    # of each (kernel, mode) (None: every one), plain versions' variants,
    # kernel_phase options)
    new_route = dict(replay_any=False, time_plain=False)
    paths = [
        ("main", (B1, B3), None, None, {}),
        ("reference", (B2, B4), FIRST, 2, {}),
        ("mid", (B1, B5), FIRST, 2, {}),
        ("main_unculled", (B6, B3), FIRST, 2, {}),
        ("reference_unculled", (B7S, B7G), FIRST, 2, {}),
        ("geometry", (B1, B3), None, 2, new_route),
        ("reference_geometry", (B2, B4), FIRST, 2, dict(new_route, modes=("closest",))),
    ]
    ref_cfg = RenderConfig(width=128, height=32, spp=1, max_bounces=1, static_geometry=True)
    for tag, expected, per_mode, plain_nv, options in paths:
        t_path = time.perf_counter()
        bridge, randomize, beams, cfg = main_path.build_shape(tag, dev, SIZE)
        resolution = main_path.SHAPES[tag][0]
        log(f"[{tag}/kernels] {BATCH} variants x {SIZE}x{SIZE} rays, spp {cfg.spp}, "
            f"{len(bridge._faces)} faces (vocalfold resolution {resolution}), tile_cull "
            f"{cfg.tile_cull}, static_geometry {cfg.static_geometry}, smooth normals "
            f"{bridge._smooth_mask is not None}"
            + (f"; launches replayed of each (kernel, mode): {per_mode}" if per_mode
               else "; every launch")
            + (f", plain versions on the first {plain_nv} variants" if plain_nv else "")
            + (f"; {options}" if options else ""))
        res = kernel_phase(tag, lambda: main_path.render_batch(bridge, randomize, beams, seeds,
                                                               cfg), per_mode, plain_nv,
                           **options)
        kres.update(res)
        if tag == "main":
            log("[main/reference]")
            reference_phase(tag, bridge, randomize, beams, dev, ref_cfg)
        if tag == "geometry":
            log("[geometry/reference]")
            reference_phase(tag, bridge, randomize, beams, dev,
                            ref_cfg.replace(static_geometry=False), grad=("translation",))
        counts = forward_phase(tag, bridge, randomize, beams, seeds, cfg, expected)
        path_launches[tag] = counts
        for name in expected:
            if name not in kernel_path:
                kernel_path[name] = tag
                launches[name] = counts[name]
        if tag == "geometry":
            pose_phase(tag, bridge, randomize, beams, seeds, cfg, dev)
        elif tag != "reference_geometry":  # bench_phase runs its step
            pattern_phase(tag, bridge, randomize, beams, seeds, cfg, dev)
        log(f"[{tag}] {time.perf_counter() - t_path:.1f} s")
        if tag == "main":
            t_tex = time.perf_counter()
            log(f"[texture] main shape, {BATCH} variants, projector texture "
                f"{main_path.BEAM_TEXTURE} rasterized from {beams.shape[0]} beams")
            reference_phase("texture", bridge, randomize, beams, dev, ref_cfg, analytic=False)
            forward_phase("texture", bridge, randomize, beams, seeds, cfg, expected,
                          analytic=False)
            pattern_phase("texture", bridge, randomize, beams, seeds, cfg, dev, analytic=False)
            log(f"[texture] {time.perf_counter() - t_tex:.1f} s")
            c2_phase(bridge, randomize, beams, seeds[:C2_VARIANTS], cfg)

    for tag, phase in (("materials", materials_phase), ("emitters", emitters_phase),
                       ("reparam", reparam_phase)):
        t_path = time.perf_counter()
        res, path_launches[tag] = phase(dev, seeds)
        kres.update(res)
        log(f"[{tag}] {time.perf_counter() - t_path:.1f} s")

    t_files = time.perf_counter()
    res, counts = scene_files_phase(dev, seeds, smi)
    kres.update(res)
    path_launches.update(counts)
    log(f"[scene_files] {time.perf_counter() - t_files:.1f} s")

    t_opt = time.perf_counter()
    path_launches["optimize"] = optimize_phase(dev)
    log(f"[optimize] {time.perf_counter() - t_opt:.1f} s")

    t_farm = time.perf_counter()
    path_launches["datagen"], path_launches["datagen_row"] = datagen_phase(dev)
    log(f"[datagen] {time.perf_counter() - t_farm:.1f} s")

    t_est = time.perf_counter()
    res, path_launches["estimation"], path_launches["estimation_optimize"] = estimation_phase(dev)
    kres.update(res)
    log(f"[estimation] {time.perf_counter() - t_est:.1f} s")

    t_films = time.perf_counter()
    res, counts = films_phase(dev, seeds)
    kres.update(res)
    path_launches.update(counts)
    log(f"[films] {time.perf_counter() - t_films:.1f} s")

    t_mxu = time.perf_counter()
    x1 = mxu_phase(dev)
    log(f"[mxu] {time.perf_counter() - t_mxu:.1f} s")

    t_probe = time.perf_counter()
    x2 = probe_phase(dev)
    log(f"[probe] {time.perf_counter() - t_probe:.1f} s")

    bench_phase()

    kernels = []
    for name, (src, body, replaces) in SOURCES.items():
        mine = [r for r in kres.values() if r["kernel"] == name and r["path"] == kernel_path[name]]
        closest = next(r for r in mine if not r["any_hit"])
        # The path's own any-hit launch where it has one (shadow rays), else
        # a closest-hit launch replayed as any-hit.
        any_hit = min((r for r in mine if r["any_hit"]), key=lambda r: r["replayed"])
        entry = {
            "name": name, "route": "cuda", "source": src, "body": body, "replaces": replaces,
            "path": kernel_path[name], "launches": launches[name],
            "ops_per_pair": OPS_PER_PAIR[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": closest["ms"], "plain_ms": closest["plain_ms"],
            "plain_variants": closest["plain_variants"],
            "bound_ms": closest["bound_ms"], "bound_by": closest["bound_by"],
            "tested_pairs": closest["pairs"], "listed_pairs": closest["listed_pairs"],
            "least_pairs": closest["least_pairs"], "least_bound_ms": closest["least_bound_ms"],
            "library_ms": None,
            "any_hit_ms": any_hit["ms"], "any_hit_plain_ms": any_hit["plain_ms"],
            "any_hit_bound_ms": any_hit["bound_ms"],
            "any_hit_least_bound_ms": any_hit["least_bound_ms"],
            # Counted launches on every path that runs the kernel: one
            # forward batch of each shape, the optimizer's OPT_STEPS steps,
            # one farm dispatch, bench's datagen row, SMARTY's depth maps
            # and the optimizer's steps from its pattern.
            "launches_by_path": {p: c[name] for p, c in path_launches.items() if c[name]},
        }
        if "lists_ms" in closest:
            entry["tile_lists_ms"] = closest["lists_ms"]
        # The face-table route's launches: B2 and B4 closest-hit without
        # emitted attributes, B1 and B3 with smooth normals; the shading
        # paths' (B4's per-ray-origin any-hit on emitters).
        for path in ("geometry", "reference_geometry", "materials", "emitters", "reparam",
                     "estimation", "xml", "yaml", "odd_film"):
            rows = [r for r in kres.values() if r["kernel"] == name and r["path"] == path]
            if rows:
                entry[path] = {"cases": len(rows),
                               "max_abs_err": max(r["max_abs_err"] for r in rows),
                               "mismatched": sum(r["mismatched"] for r in rows),
                               "closest_ms": next((r["ms"] for r in rows if not r["any_hit"]),
                                                  None),
                               "any_hit_ms": [r["ms"] for r in rows if r["any_hit"]],
                               "any_hit_bound_ms": [r["bound_ms"] for r in rows if r["any_hit"]]}
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
