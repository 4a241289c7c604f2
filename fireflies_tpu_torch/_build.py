"""Build and load the hand-written CUDA kernels of `csrc/`.

On first use, `nvcc` compiles every `csrc/*.cu` file for Hopper
(`sm_90a`) into one shared library with a plain C interface under
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
# exactly like the plain PyTorch versions' separate elementwise ops.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
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
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
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


def stream_of(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
