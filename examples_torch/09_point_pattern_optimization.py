"""Overlap-regularized point-pattern optimization.

Twin of examples/09_point_pattern_optimization.py: Adam on 2D point
coordinates, L1(softor, sum) overlap loss, clamp to [0, 1].
"""

import numpy as np
import torch

from _common import device, out_dir

from fireflies_tpu_torch import optim
from fireflies_tpu_torch.graphics import rasterization
from fireflies_tpu_torch.utils.png import write_png

if __name__ == "__main__":
    dev = device()
    res = optim.optimize_point_pattern(
        0, n_points=150, sigma=100.0, texture_size=(256, 256), steps=150,
        learning_rate=2e-3, chunk=50, device=dev,
    )
    print(f"loss {float(res.losses[0]):.5f} -> {float(res.losses[-1]):.5f}")

    d = out_dir("09_point_pattern_optimization")
    # optimize_point_pattern's starting points: the same generator's draws.
    start = torch.rand((150, 2), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    with torch.no_grad():
        before = rasterization.softor_points(start, 100.0, (256, 256), chunk=50)
        after = rasterization.softor_points(res.points, 100.0, (256, 256), chunk=50)
    write_png(str(d / "before.png"), before.cpu().numpy())
    write_png(str(d / "after.png"), after.cpu().numpy())
    np.save(d / "points.npy", res.points.cpu().numpy())
    print("wrote before/after to", d)
