"""Port parity: mesh I/O (`utils/io.py`) against the JAX package.

OBJ (the Python parser: fan triangulation, negative indices, face uvs),
PLY (ASCII and binary in both byte orders), Mitsuba serialized files
written by either package and read by the other, OBJ frame sequences and
Blender NURBS curves.  Tolerances: arrays and bytes exact; NURBS points
and tangents within 1e-6.
"""

import struct

import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu.utils import io as jx_io
from fireflies_tpu_torch.utils import io as tc_io

torch.set_num_threads(1)

PARITY = "tools/parity_scenes"


def _same_mesh(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_load_obj_matches_jax(tmp_path):
    for name in ("vocalfold_mesh0.obj", "vocalfold_mesh1.obj"):
        mine = tc_io.load_obj(f"{PARITY}/{name}")
        _same_mesh(mine, jx_io._load_obj_python(f"{PARITY}/{name}"))
    assert mine["faces"].shape == (288, 3)
    quads = tmp_path / "quads.obj"
    quads.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 1 0\n"
                     "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
                     "f 1/1/1 2/2/1 3/3/1 4/4/1\nf -3/2 -1/3 -2/4\n")
    neg = tmp_path / "neg.obj"
    neg.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\nf 1 2 3\n")
    for p in (quads, neg):
        _same_mesh(tc_io.load_obj(p), jx_io._load_obj_python(p))
    assert tc_io.load_obj(quads)["faces"].tolist() == [[0, 1, 2], [0, 2, 3], [2, 4, 3]]
    assert tc_io.load_obj(neg)["faces"].tolist() == [[0, 1, 2], [0, 1, 2]]
    assert tc_io.load_obj(neg)["face_uvs"] is None


def _ply_files(tmp_path) -> list:
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    ascii_ply = tmp_path / "quad.ply"
    with open(ascii_ply, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment test quad\nelement vertex 4\n")
        f.write("".join(f"property float {p}\n" for p in ("x", "y", "z", "s", "t")))
        f.write("element face 1\nproperty list uchar int vertex_indices\nend_header\n")
        for v, uv in zip(verts, verts[:, :2]):
            f.write(" ".join(map(str, list(v) + list(uv))) + "\n")
        f.write("4 0 1 2 3\n")
    le = tmp_path / "le.ply"
    with open(le, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
                 + "".join(f"property float {p}\n" for p in ("x", "y", "z", "nx", "ny", "nz"))
                 + "element face 1\nproperty list uchar int vertex_indices\nend_header\n").encode())
        for v in verts:
            f.write(struct.pack("<6f", *v, 0.0, 0.0, 1.0))
        f.write(struct.pack("<B4i", 4, 0, 1, 2, 3))
    be = tmp_path / "be.ply"
    with open(be, "wb") as f:
        f.write(("ply\nformat binary_big_endian 1.0\nelement vertex 3\n"
                 + "".join(f"property float {p}\n" for p in ("x", "y", "z"))
                 + "element face 1\nproperty list uchar int vertex_indices\nend_header\n").encode())
        for v in verts[:3]:
            f.write(struct.pack(">3f", *v))
        f.write(struct.pack(">B3i", 3, 0, 1, 2))
    return [ascii_ply, le, be]


def test_load_ply_matches_jax(tmp_path):
    """tests/test_scene_io_aux.py's PLY cases: an ASCII quad with s/t uvs,
    binary little-endian with normals, binary big-endian."""
    ascii_ply, le, be = _ply_files(tmp_path)
    for p in (ascii_ply, le, be):
        _same_mesh(tc_io.load_mesh(p), jx_io.load_mesh(p))
    m = tc_io.load_ply(ascii_ply)
    assert m["faces"].tolist() == [[0, 1, 2], [0, 2, 3]]
    np.testing.assert_array_equal(m["uvs"], m["vertices"][:, :2])
    np.testing.assert_array_equal(tc_io.load_ply(le)["normals"], [[0, 0, 1]] * 4)
    assert tc_io.load_ply(be)["faces"].tolist() == [[0, 1, 2]]


def test_serialized_across_packages(tmp_path):
    """Files written by either package: the same bytes, and each package
    reads the other's shapes back exactly."""
    rng = np.random.default_rng(0)
    meshes = [
        {"name": "a", "vertices": rng.normal(size=(17, 3)).astype(np.float32),
         "faces": rng.integers(0, 17, size=(9, 3)).astype(np.int32),
         "uvs": rng.random((17, 2)).astype(np.float32),
         "normals": rng.normal(size=(17, 3)).astype(np.float32)},
        {"name": "b", "vertices": rng.normal(size=(5, 3)).astype(np.float32),
         "faces": np.asarray([[0, 1, 2], [2, 3, 4]], np.int32)},
    ]
    mine, theirs = tmp_path / "mine.serialized", tmp_path / "theirs.serialized"
    tc_io.save_serialized(mine, meshes)
    jx_io.save_serialized(theirs, meshes)
    assert mine.read_bytes() == theirs.read_bytes()
    for i, m in enumerate(meshes):
        for out in (tc_io.load_serialized(theirs, shape_index=i),
                    jx_io.load_serialized(mine, shape_index=i)):
            np.testing.assert_array_equal(out["vertices"], m["vertices"])
            np.testing.assert_array_equal(out["faces"], m["faces"])
            for k in ("uvs", "normals"):
                if k in m:
                    np.testing.assert_array_equal(out[k], m[k])
                else:
                    assert out[k] is None
        _same_mesh(tc_io.load_mesh(theirs, shape_index=i), jx_io.load_mesh(mine, shape_index=i))


def test_obj_sequence_and_nurbs_match_jax(tmp_path):
    """save_obj writes the JAX package's bytes; load_obj_sequence stacks the
    frames as it does; import_blender_nurbs_obj reads the same curve, whose
    points and tangents agree within 1e-6."""
    rng = np.random.default_rng(1)
    faces = np.array([[0, 1, 2], [1, 2, 3]], np.int32)
    (tmp_path / "frames").mkdir()
    for i in range(3):
        v = rng.normal(size=(4, 3)).astype(np.float32)
        tc_io.save_obj(tmp_path / "frames" / f"f{i}.obj", v, faces)
        jx_io.save_obj(tmp_path / f"jx{i}.obj", v, faces)
        assert (tmp_path / "frames" / f"f{i}.obj").read_bytes() == (
            tmp_path / f"jx{i}.obj").read_bytes()
    seq = tc_io.load_obj_sequence(tmp_path / "frames")
    assert seq.shape == (3, 4, 3)
    np.testing.assert_array_equal(seq, jx_io.load_obj_sequence(tmp_path / "frames"))

    curve_obj = tmp_path / "curve.obj"
    cps = rng.normal(size=(6, 3))
    curve_obj.write_text("".join(f"v {x} {y} {z} 1.0\n" for x, y, z in cps)
                         + "deg 3\nparm u 0 0 0 0 0.3 0.6 1 1 1 1\n")
    mine, theirs = tc_io.import_blender_nurbs_obj(curve_obj), jx_io.import_blender_nurbs_obj(curve_obj)
    np.testing.assert_array_equal(mine.control_points, theirs.control_points)
    np.testing.assert_array_equal(mine.knots, theirs.knots)
    assert mine.degree == theirs.degree == 3
    for t in (0.0, 0.1, 0.45, 0.6, 0.999, 1.0):
        np.testing.assert_allclose(mine.evaluate(torch.tensor(t)).numpy(),
                                   np.asarray(theirs.evaluate(jnp.float32(t))), atol=1e-6)
        np.testing.assert_allclose(mine.tangent(torch.tensor(t)).numpy(),
                                   np.asarray(theirs.tangent(jnp.float32(t))), atol=1e-6)
    ts = np.linspace(0, 1, 7, dtype=np.float32)
    np.testing.assert_allclose(mine.evaluate_many(torch.from_numpy(ts)).numpy(),
                               np.asarray(theirs.evaluate_many(jnp.asarray(ts))), atol=1e-6)
