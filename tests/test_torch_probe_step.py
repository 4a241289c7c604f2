"""`perf_probe.probe_step`, the step-level split of the batched pattern step
(the counterpart of tools/perf_probe.py::probe_step), on the CPU at a tiny
size: the three rows, `full`'s share exactly 1, every time finite; a subset
keeps `full`; the reference's FF_* knob variants are refused with the
reason.
"""

import math

import pytest
import torch

from fireflies_tpu_torch import perf_probe

torch.set_num_threads(1)

TINY = dict(size=16, batch=1, n_iter=1, resolution=4, trials=1)


def test_probe_step_rows_on_the_cpu(capsys):
    rows = perf_probe.probe_step("cpu", **TINY)
    assert [r["probe"] for r in rows] == ["step_full", "step_fwd_only", "step_bounces1"]
    assert rows[0]["frac_of_full"] == 1.0
    for r in rows:
        assert math.isfinite(r["ms"]) and r["ms"] > 0, r
        assert math.isfinite(r["renders_s"]) and math.isfinite(r["frac_of_full"]), r
        assert r["renders_s"] == pytest.approx(1e3 / r["ms"])
    printed = capsys.readouterr().out
    assert all(f'"probe": "{r["probe"]}"' in printed for r in rows)
    subset = perf_probe.probe_step("cpu", variants=["bounces1"], analytic=True, **TINY)
    assert [r["probe"] for r in subset] == ["step_full", "step_bounces1"]
    with pytest.raises(ValueError, match="FF_"):
        perf_probe.probe_step("cpu", variants=["no_occl"], **TINY)
