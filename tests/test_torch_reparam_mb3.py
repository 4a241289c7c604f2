"""The warped-area gradient on the scene that needs it (tests/
test_mb3_grad_nan.py's: camera -> wall A -> wall B -> an emissive panel,
with a grey blocker between B and the panel, translated by dx), at its 8x8
film, spp 2, `max_bounces=3`:

`render_rgb(reparam=True, reparam_indirect=True, reparam_ind_bounces=2)`
warps the first two BSDF-sampled directions, so the blocker's silhouette,
seen from wall B, carries d(mean red)/d(dx).  Each of VARIANTS variants
(its own generator and its own dx) gives one sample of that gradient at
dx = 1; the port's central finite difference of the plain render at
dx = 1 +- 0.25, with the same generators, gives a sample of the secant slope.
The two means must agree within twice their combined standard error,
sqrt(se_grad^2 + se_fd^2), and the gradient must exceed twice its own
standard error (a lost boundary term gives exactly 0).  The reference's
notes measured the finite difference at 0.046 +- 0.004 (CLAUDE.md); the
JAX package's own gradient is NaN here (tests/test_mb3_grad_nan.py).  The
scene and the samples are `main_path.blocker_scene` /
`blocker_gradient_samples`; `PYTHONPATH=. python
tests/test_torch_reparam_mb3.py [variants]` prints both numbers.
"""

import sys

import numpy as np
import torch

from fireflies_tpu_torch.main_path import blocker_gradient_samples

torch.set_num_threads(1)

VARIANTS = 128


def summary(grad: np.ndarray, fd: np.ndarray):
    """(mean, standard error) of each."""
    n = len(grad)
    return ((float(grad.mean()), float(grad.std(ddof=1) / np.sqrt(n))),
            (float(fd.mean()), float(fd.std(ddof=1) / np.sqrt(n))))


def test_warped_area_gradient_matches_the_finite_difference():
    grad, fd = blocker_gradient_samples(VARIANTS, device="cpu")
    assert np.isfinite(grad).all() and np.isfinite(fd).all()
    (g, se_g), (f, se_f) = summary(grad, fd)
    assert f > 0 and se_f > 0, (f, se_f)  # the blocker's edges are reached
    # Moving the blocker in its own plane changes only what wall B sees of
    # it, so without the warped bounces the gradient is 0: the gradient must
    # stand clear of 0, which the bound below alone cannot tell at this size.
    assert g > 2 * se_g, (g, se_g)
    assert abs(g - f) <= 2 * np.hypot(se_g, se_f), ((g, se_g), (f, se_f))


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else VARIANTS
    (g, se_g), (f, se_f) = summary(*blocker_gradient_samples(n, device="cpu"))
    print(f"{n} variants: warped-area gradient {g:.6g} +- {se_g:.3g}, "
          f"finite difference {f:.6g} +- {se_f:.3g}")
