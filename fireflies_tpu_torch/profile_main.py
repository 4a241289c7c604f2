"""Where a render path's device time goes, from torch.profiler's device events.

    python -m fireflies_tpu_torch.profile_main [--shape main] [--size 512] [--batch 16]
        [--analytic 1] [--static-geometry 0|1] [--pose-reparam CHUNK]

`--shape` picks one of the shapes chip_smoke.py drives (`main_path.SHAPES`),
all with 2 bounces: `main` (1440 faces, spp 1; B1 and B3, the default),
`mid` (5288 faces, spp 1; B1 and B5), `reference` (the reference-realistic
shape: 11538 faces, spp 4, coherent bounce, shared primary; B2 and B4), and
with tile culling off `main_unculled` (B6 and B3) and `reference_unculled`
(B7s and B7g), on the face-table attribute route `geometry` (main with
smooth normals) and `reference_geometry` (bench.py's static_geom=0 row),
and the shading shapes of `main_path.BUILDERS`: `materials` (the farm
scene with material maps; B1 and B3), `emitters` (9046 faces, spp 4,
3 bounces, no projector, so no pattern step; B2 and B4), and the scene
files `xml` (vocalfold.xml, 1440 faces) and `yaml` (a scene description
with OBJ-frame animation and a Perlin texture, 1536 faces; both B1 and
B3).
`--analytic 0` takes the texture route (the beams rasterized into a
256x256 projector texture) in place of the analytic beam splat;
`--static-geometry` overrides the shape's (0: the face-table route).
Profiles one forward batch (`render_batch` under no_grad) and one pattern
step over the same batch (one batched render, one backward), each after a
warm-up; with `--pose-reparam CHUNK` the step is bench's `pose_reparam`
step instead (`main_path.pose_step` under `RenderConfig(reparam=True,
reparam_chunk=CHUNK)`, the face-table route, against targets rendered
once) and the forward is its two passes.  Prints for each:

- wall: host time of the run, with and without the profiler attached
  (median of 3 unprofiled runs);
- busy: the union of the intervals of every event the profiler recorded on
  the card (kernels, memcpy, memset), so nothing is counted twice;
- busy share: busy over the unprofiled wall (busy over the profiled wall in
  brackets, a lower bound);
- device time by kernel name, largest first, with the hand-written
  intersection kernels named.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import time
from collections import defaultdict

import torch

from fireflies_tpu_torch import main_path

# Substrings of the hand-written kernels' names, demangled or mangled.  Kernels
# that share a template are told apart by its leading arguments: the table's
# rows and lists for the shared-origin body (B1, B2, B6, B7s), lists for the
# general one (B3, B5).
KERNEL_NAMES = {
    "B1 intersect_shared_culled": ("intersect_shared_kernel<12, true,",
                                   "intersect_shared_kernelILi12ELb1E"),
    "B3 intersect_general": ("intersect_general_kernel<false,", "intersect_general_kernelILb0E"),
    "B2 intersect_stream_culled": ("intersect_shared_kernel<16, true,",
                                   "intersect_shared_kernelILi16ELb1E"),
    "B4 intersect_stream_general_culled": ("stream_general_kernel<true>",
                                           "stream_general_kernelILb1E"),
    "B5 intersect_general_culled": ("intersect_general_kernel<true,",
                                    "intersect_general_kernelILb1E"),
    "B6 intersect_shared": ("intersect_shared_kernel<12, false,",
                            "intersect_shared_kernelILi12ELb0E"),
    "B7s intersect_stream": ("intersect_shared_kernel<16, false,",
                             "intersect_shared_kernelILi16ELb0E"),
    "B7g intersect_stream_general": ("stream_general_kernel<false>", "stream_general_kernelILb0E"),
    "X1 intersect_mxu_shared": ("intersect_mxu_kernel(", "intersect_mxu_kernelEPKf"),
}


def device_events(prof) -> list:
    """(start_us, end_us, name) of every event that ran on the card."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def union_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, lo, hi = 0.0, None, None
    for s, e, _ in sorted(events):
        if hi is None or s > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total + (0.0 if hi is None else hi - lo)


def by_name(events) -> list[tuple[str, float, int]]:
    """(name, total us, count), largest total first."""
    acc = defaultdict(lambda: [0.0, 0])
    for s, e, name in events:
        acc[name][0] += e - s
        acc[name][1] += 1
    return sorted(((n, t, c) for n, (t, c) in acc.items()), key=lambda r: -r[1])


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def report(tag: str, fn, top: int) -> None:
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    fn()  # warm-up
    wall = statistics.median(_wall(fn) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = _wall(fn)
    events = device_events(prof)
    busy = union_us(events) / 1e3
    print(f"== {tag}: wall {wall * 1e3:.3f} ms (profiled {wall_prof * 1e3:.3f} ms), "
          f"device busy {busy:.3f} ms, busy share {busy / (wall * 1e3):.4f} "
          f"({busy / (wall_prof * 1e3):.4f} of the profiled wall), "
          f"{len(events)} device events", flush=True)
    rows = by_name(events)
    for label, keys in KERNEL_NAMES.items():
        mine = [r for r in rows if any(k in r[0] for k in keys)]
        if mine:
            t, c = sum(r[1] for r in mine), sum(r[2] for r in mine)
            print(f"  {label}: {t / 1e3:.3f} ms in {c} launches", flush=True)
    for name, t, c in rows[:top]:
        print(f"  {t / 1e3:10.3f} ms {c:6d}x  {name[:100]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--shape", choices=sorted([*main_path.SHAPES, *main_path.BUILDERS]),
                    default="main")
    ap.add_argument("--analytic", type=int, choices=(0, 1), default=1)
    ap.add_argument("--static-geometry", type=int, choices=(0, 1), default=None)
    ap.add_argument("--pose-reparam", type=int, default=0, metavar="CHUNK",
                    help="profile bench's pose_reparam step with this reparam_chunk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main needs a CUDA device")
    dev = torch.device("cuda", 0)
    bridge, randomize, beams, cfg = main_path.build_shape(args.shape, dev, args.size)
    if args.static_geometry is not None:
        cfg = cfg.replace(static_geometry=bool(args.static_geometry))
    seeds = list(range(args.batch))
    if args.pose_reparam:
        cfg = cfg.replace(static_geometry=False, reparam=True, reparam_chunk=args.pose_reparam)
        targets = main_path.pose_targets(bridge, randomize, beams, seeds, cfg,
                                         render_seeds=[s + args.batch for s in seeds])

    analytic = bool(args.analytic)

    def forward():
        with torch.no_grad():
            main_path.render_batch(bridge, randomize, beams, seeds, cfg, analytic)

    def step():
        if args.pose_reparam:
            main_path.pose_step(bridge, randomize, beams, torch.zeros(3, device=dev), seeds,
                                targets, cfg)
        else:
            main_path.pattern_step(bridge, randomize, beams, seeds, cfg, analytic)

    print(f"{torch.cuda.get_device_name(0)}, {len(bridge._faces)} faces, "
          f"{args.size}x{args.size}, spp {cfg.spp}, batch {args.batch}, "
          f"{'analytic' if analytic else 'texture'} projector, static_geometry "
          f"{cfg.static_geometry}, smooth normals {bridge._smooth_mask is not None}", flush=True)
    report(f"forward, batch {args.batch}", forward, args.top)
    if bridge._scene.projector() is None:
        return
    torch.cuda.reset_peak_memory_stats(dev)
    name = f"pose_reparam step (chunk {args.pose_reparam})" if args.pose_reparam else "pattern step"
    report(f"{name}, batch {args.batch}", step, args.top)
    print(f"{name} peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB",
          flush=True)


if __name__ == "__main__":
    main()
