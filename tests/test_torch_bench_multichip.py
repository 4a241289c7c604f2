"""Port parity for `bench.measure_multichip` and `bench.measure_datagen(
multichip=True)`, the counterparts of bench.py's scale-out measurements, on
two gloo ranks (spawned once, through the bench's own `_run_ranks`, each
rank calling both functions as a rank of the group):

  * the multichip line is well formed (2 ranks, renders/s = repeats x
    batch_per_chip x ranks / the best window, its spread), and its untimed
    first step's loss and (144, 3) beam gradient equal one process's
    `main_path.pattern_step` over the same 4 generators (vocalfold
    resolution 8, 16x16, 2 bounces, 2 variants a rank) to 1e-5 relative;
  * the farm over the two ranks (2 frames a rank a dispatch) accepts and
    writes the frames of the one-process farm with a batch of 4: the same
    count and the same manifest (the sha256 over the PNG files');
  * a rank that raises makes the call raise (the command exits non-zero).
"""

import numpy as np
import pytest
import torch
from torch.multiprocessing.spawn import ProcessException

from fireflies_tpu_torch import bench, main_path
from fireflies_tpu_torch.utils.seeds import step_seeds

torch.set_num_threads(1)

SIZE, RESOLUTION, PER_RANK, WORLD = 16, 8, 2, 2
FARM = dict(size=SIZE, spp=1, resolution=RESOLUTION, n_frames=6)


def _both(device):
    """Both measurements as this rank of the group."""
    return {"line": bench.measure_multichip(size=SIZE, resolution=RESOLUTION,
                                            batch_per_chip=PER_RANK, repeats=2, trials=2,
                                            first_step=True, device=device),
            "farm": bench.measure_datagen(**FARM, batch=PER_RANK, multichip=True,
                                          device=device)}


def _fails(device):
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()


def test_multichip_line_and_farm_match_one_process():
    out = bench._run_ranks(_both, WORLD, "cpu", {})
    line, farm = out["line"], out["farm"]
    d = line["detail"]
    assert line["unit"] == "renders/sec" and "across 2 CPU rank(s)" in line["metric"]
    assert d["chips"] == WORLD and d["batch_per_chip"] == PER_RANK and d["backend"] == "gloo"
    assert d["renders_per_sec_dispersion"]["trials"] == 2
    assert line["value"] == d["renders_per_sec_dispersion"]["max"] > 0
    assert d["per_chip"] == pytest.approx(line["value"] / WORLD, rel=1e-3)
    assert d["device"] == "cpu" and d["peak_device_memory_gib"] is None

    first = d["first_step"]
    bridge, randomize, rays0 = main_path.build("cpu", resolution=RESOLUTION)
    cfg = main_path.bench_config(size=SIZE)
    loss, grad = main_path.pattern_step(bridge, randomize, rays0,
                                        step_seeds(first["seed"], 0, WORLD * PER_RANK), cfg)
    got = np.asarray(first["grad"], np.float32)
    assert got.shape == (144, 3) and np.abs(got).max() > 0
    np.testing.assert_allclose(first["loss"], float(loss), rtol=1e-5)
    assert np.linalg.norm(got - grad.numpy()) <= 1e-5 * np.linalg.norm(grad.numpy())

    one = bench.measure_datagen(**FARM, batch=WORLD * PER_RANK, device="cpu")
    assert farm["unit"] == "frames/sec/chip" and farm["detail"]["chips"] == WORLD
    assert farm["detail"]["frames_per_sec_total"] == pytest.approx(WORLD * farm["value"],
                                                                   rel=1e-2)
    assert farm["detail"]["frames_accepted"] == one["detail"]["frames_accepted"] >= 6
    assert farm["detail"]["manifest"] == one["detail"]["manifest"]


def test_a_failing_rank_fails_the_call():
    # Rank 1's error, or rank 0's when its barrier loses rank 1 first.
    with pytest.raises(ProcessException):
        bench._run_ranks(_fails, WORLD, "cpu", {})
