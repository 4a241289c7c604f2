"""Timing, tracing and metrics (port of fireflies_tpu/utils/profiling.py).

  * `time_it(fn, *args)`: median / min / max wall seconds after a warm-up,
    the card synchronized when the output lives there;
  * `Throughput`: units per second for long jobs (renders/s);
  * `MetricsLogger`: structured JSONL metrics a step;
  * `trace(log_dir)`: a `torch.profiler` trace of the block, written as a
    Chrome trace (`trace.json`) under `log_dir`;
  * `debug_nans()`: `torch.autograd.set_detect_anomaly` over the block.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch


def _synchronize(out) -> None:
    """Wait for the card when some tensor of `out` lives there."""
    tensors = out if isinstance(out, (list, tuple)) else (
        list(out.values()) if isinstance(out, dict) else [out])
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def time_it(fn, *args, repeats: int = 10, warmup: int = 1, **kwargs) -> dict:
    """Median / min / max wall-clock seconds of fn(*args, **kwargs) over
    `repeats` calls after `warmup` calls."""
    for _ in range(warmup):
        _synchronize(fn(*args, **kwargs))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0], "max_s": times[-1],
            "repeats": repeats}


class Throughput:
    """Rolling renders/s (or any unit a second) counter."""

    def __init__(self):
        self._start = time.perf_counter()
        self._count = 0

    def add(self, n: int = 1) -> None:
        self._count += n

    @property
    def per_second(self) -> float:
        dt = time.perf_counter() - self._start
        return self._count / dt if dt > 0 else 0.0

    def reset(self) -> None:
        self._start = time.perf_counter()
        self._count = 0


class MetricsLogger:
    """Append-only JSONL metrics: one line a `log` call, with the step, the
    wall seconds since construction (4 decimals) and the given scalars as
    floats."""

    def __init__(self, path: str | Path | None = None, echo: bool = True):
        self._path = Path(path) if path else None
        self._echo = echo
        self._t0 = time.perf_counter()
        if self._path:
            self._path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **scalars) -> None:
        record = {"step": int(step), "wall_s": round(time.perf_counter() - self._t0, 4)}
        for k, v in scalars.items():
            record[k] = float(v)
        line = json.dumps(record)
        if self._path:
            with open(self._path, "a") as f:
                f.write(line + "\n")
        if self._echo:
            print(line)


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block's host and device activity with `torch.profiler`
    and write it as `<log_dir>/trace.json` (chrome://tracing, Perfetto)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly mode within the block: a backward function that
    returns NaN raises a RuntimeError naming it.

    What it catches that JAX's `jax_debug_nans` does not: for any error in a
    backward (a NaN gradient, or a saved tensor changed in place, which JAX
    cannot do), the traceback of the forward call that built the failing
    node.  What it misses that JAX's flag catches: a NaN made by a forward
    operation, which passes unseen until some backward turns it into a NaN
    gradient (and always, with no backward at all)."""
    with torch.autograd.set_detect_anomaly(enable):
        yield
