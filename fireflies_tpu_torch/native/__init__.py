"""The native host library: ctypes bindings for `src/fireflies_native.cpp`
(port of fireflies_tpu/native).

Four host-side functions with the JAX module's signatures: `parse_obj`,
`bridson`, `connected_components` and `morton_order`.  Their callers take
them exactly where the JAX package's callers take its library
(`sampling.bridson` for the "default" radius type, `utils.io.load_obj`,
`datagen.connected_components`, `render.bridge`'s Morton order), so that
Bridson draws the JAX package's default points from the same seed
(std::mt19937_64 in the library, numpy's generator in the plain version).

On first use `g++` builds the library with the JAX package's Makefile
flags (CXX_FLAGS, so that both libraries are compiled alike) into
`build/fireflies_tpu_torch/` at the root of the checkout, keyed by a hash of
the source and the flags; `ctypes` loads it.  Nothing happens at import
time.  FIREFLIES_NO_NATIVE=1 (read at each call, as `enabled()`) makes the
callers take their plain Python or numpy versions, as it does in the JAX
package.  Unlike the JAX package, a missing compiler or a failed build is
never a quiet fallback: the call raises with the compiler's message.

`calls` counts the calls into the library by function, so that a run can
show which path it took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "fireflies_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "fireflies_tpu_torch"
CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]

calls = {"parse_obj": 0, "bridson": 0, "connected_components": 0, "morton_order": 0}


def enabled() -> bool:
    """False when FIREFLIES_NO_NATIVE is set: the callers take their plain
    versions."""
    return not os.environ.get("FIREFLIES_NO_NATIVE")


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("face_uvs", ctypes.POINTER(ctypes.c_int32)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("n_vertices", ctypes.c_int64),
        ("n_faces", ctypes.c_int64),
        ("n_uvs", ctypes.c_int64),
        ("n_normals", ctypes.c_int64),
        ("has_face_uvs", ctypes.c_int32),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfireflies_native_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if the hash-keyed library is missing) and load the library;
    raises RuntimeError when the compiler is missing or fails."""
    so = library_path()
    if not so.exists():
        cxx = shutil.which(CXX)
        if cxx is None:
            raise RuntimeError(f"{CXX} not found: the native host library cannot be built "
                               "(FIREFLIES_NO_NATIVE=1 selects the plain versions)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed ({proc.returncode}) on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.ff_parse_obj.argtypes = [ctypes.c_char_p]
    lib.ff_parse_obj.restype = ctypes.POINTER(_ObjMesh)
    lib.ff_free_obj.argtypes = [ctypes.POINTER(_ObjMesh)]
    lib.ff_free_obj.restype = None
    lib.ff_bridson.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.ff_bridson.restype = ctypes.c_int64
    lib.ff_connected_components.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64]
    lib.ff_connected_components.restype = ctypes.c_int32
    lib.ff_morton_order.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.ff_morton_order.restype = None
    return lib


def parse_obj(path: str) -> dict:
    """An OBJ file as `utils.io.load_obj` returns it (faces fan-triangulated,
    negative indices counted from the end); FileNotFoundError when it cannot
    be opened."""
    lib = load_library()
    calls["parse_obj"] += 1
    mesh_ptr = lib.ff_parse_obj(str(path).encode())
    if not mesh_ptr:
        raise FileNotFoundError(path)
    m = mesh_ptr.contents
    try:
        def arr(ptr, n, comps, dtype):
            if not ptr or n == 0:
                return None
            return np.ctypeslib.as_array(ptr, shape=(n * comps,)).reshape(
                n, comps).astype(dtype).copy()

        out = {
            "vertices": arr(m.vertices, m.n_vertices, 3, np.float32),
            "faces": arr(m.faces, m.n_faces, 3, np.int32),
            "uvs": arr(m.uvs, m.n_uvs, 2, np.float32),
            "face_uvs": arr(m.face_uvs, m.n_faces, 3, np.int32) if m.has_face_uvs else None,
            "normals": arr(m.normals, m.n_normals, 3, np.float32),
        }
        if out["vertices"] is None:
            out["vertices"] = np.zeros((0, 3), np.float32)
        if out["faces"] is None:
            out["faces"] = np.zeros((0, 3), np.int32)
        return out
    finally:
        lib.ff_free_obj(mesh_ptr)


def bridson(radius_map: np.ndarray, k: int = 30, seed: int = 0) -> tuple[int, np.ndarray]:
    """Bridson's Poisson-disk sampling over the (H, W) float32 radius map
    from std::mt19937_64(seed): (n, (n, 2) float64 (y, x))."""
    lib = load_library()
    calls["bridson"] += 1
    radius_map = np.ascontiguousarray(radius_map, np.float32)
    h, w = radius_map.shape
    max_points = max(int(4 * h * w / max(float(radius_map.min()) ** 2, 1e-6)), 1024)
    out = np.empty((max_points, 2), np.float32)
    n = lib.ff_bridson(radius_map.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, k, seed,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_points)
    return int(n), out[:n].astype(np.float64)


def connected_components(mask: np.ndarray) -> int:
    """The number of 4-connected components of a 2-D mask."""
    lib = load_library()
    calls["connected_components"] += 1
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    return int(lib.ff_connected_components(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w))


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """The (N,) int32 order of (N, 3) centroids (as float32) along a 3-D
    Morton curve of 10 bits an axis; ties keep their index order."""
    centroids = np.ascontiguousarray(centroids, np.float32)
    if centroids.ndim != 2 or centroids.shape[1] != 3:
        raise ValueError(f"centroids must be (N, 3), got {centroids.shape}")
    lib = load_library()
    calls["morton_order"] += 1
    n = centroids.shape[0]
    out = np.empty((n,), np.int32)
    lib.ff_morton_order(centroids.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
