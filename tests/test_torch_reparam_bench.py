"""`bench.measure(grad_mode="pose_reparam", device="cpu")`, the port's
warped-area pose step (`main_path.pose_step` under `RenderConfig(reparam=
True)`: the path-traced L2, its boundary gradients from the warped pass,
the warp recomputed `reparam_chunk` rays at a time in the backward), at a
tiny size on the CPU's plain versions of the kernels (64x64, chunk 2048:
the backward recomputes the warp in two chunks): the line is well-formed
and its loss finite.  Most of its time is the plain versions' aux and
shadow-feature ray casts.
"""

import numpy as np
import torch

from fireflies_tpu_torch import bench

torch.set_num_threads(1)


def test_bench_measure_pose_reparam_cpu_line():
    line = bench.measure(size=64, bounces=1, repeats=1, resolution=6, batch=1, trials=1,
                         grad_mode="pose_reparam", reparam_chunk=2048, device="cpu")
    assert set(line) == {"metric", "value", "unit", "detail"}
    assert line["metric"].startswith("64x64 diff-renders/sec/chip (vocalfold ")
    assert "pose-grad reparam chunk2048" in line["metric"] and "diff-attrs" in line["metric"]
    assert line["unit"] == "renders/sec/chip" and np.isfinite(line["value"]) and line["value"] > 0
    detail = line["detail"]
    assert detail["grad_mode"] == "pose_reparam" and detail["static_geometry"] is False
    assert detail["reparam_chunk"] == 2048 and detail["reparam_k_aux"] == 8
    assert detail["device"] == "cpu" and detail["peak_device_memory_gib"] is None
    assert np.isfinite(detail["loss"]) and detail["loss"] > 0
