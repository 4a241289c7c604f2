"""Build and load the hand-written CUDA kernels of `csrc/`.

On first use, `nvcc` compiles every `csrc/*.cu` file for Hopper
(`sm_90a`), one process per source, all started together, and links the
objects into one shared library with a plain C interface under
`build/fireflies_tpu_torch/` at the root of the checkout, keyed by a hash
of the sources and flags; `ctypes` loads it.  No PyTorch headers are
involved, so a build takes seconds.  Nothing here runs at import time.

Each kernel is reached through a `Kernel` handle that declares the C
signature and counts launches: a wrapper adds one to `launches` exactly
where it launches the kernel, so a run can show that it went through it.
On request the handle also keeps each launch's inputs (`recorded`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "fireflies_tpu_torch"

# --fmad=false: no contraction of a*b+c into one FMA, so the kernels round
# exactly like the plain PyTorch versions' separate elementwise ops.  The
# general streamed kernel of csrc/intersect_stream.cuh (B4, B7g) fuses with
# explicit __fmaf_rn, which the flag leaves alone; its plain version rounds
# each of those steps once (`render.cuda.intersect_kernel.fma32`).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libff_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if the hash-keyed library is missing) and load the kernels.
    The compiler's resource report (`-Xptxas -v`) lands beside the library
    as `<name>.log`."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = so.with_suffix(f".{os.getpid()}")
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = stem.with_name(f"{stem.name}.{src.stem}.o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out}")
        if not failed:
            tmp = stem.with_name(stem.name + ".tmp")
            proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True, check=False)
            log.append(f"== link\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
        so.with_suffix(".log").write_text("".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


class Kernel:
    """A C entry point of the kernel library plus its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.recorded: list[dict] | None = None  # set to [] to keep each launch's inputs

    def record(self, **inputs) -> None:
        """Keep a launch's inputs (the wrapper's own arguments) while
        `recorded` is a list, so that a run's launches can be replayed
        through the kernel and its plain version at the shapes they had."""
        if self.recorded is not None:
            self.recorded.append(inputs)

    @functools.cached_property
    def fn(self):
        fn = getattr(load_library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream) and
        raise on a nonzero cudaError_t; counts the launch."""
        rc = self.fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with cudaError_t {rc}")
        self.launches += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on the
    CUDA `device` (the kernels take raw pointers)."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def tested_ptr(tested: torch.Tensor | None, shape: tuple, device) -> ctypes.c_void_p | None:
    """The kernels' optional `tested` output: per ray, the clusters whose
    faces it was tested against (int32, shaped like tmax), which the pair-test
    bound of a launch is counted from.  None is a null pointer (not
    counted).  Only the kernels count: a CPU tensor raises."""
    if tested is None:
        return None
    check_cuda("tested", tested, torch.int32, shape, device)
    return ptr(tested)


def stream_of(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
