"""fireflies-tpu-torch: the PyTorch/CUDA port of fireflies-tpu.

The JAX package `fireflies_tpu` stays the reference; this package ports its
main path (vocalfold randomize -> assemble -> render_rgb -> beam gradient)
to PyTorch, with the ray/triangle intersection kernels written by hand in
CUDA C++ for Hopper (`csrc/`, built on first use by `_build.py`), and the
two loops users run around it: the pattern optimizer (`optim`) and the
dataset farm (`datagen`, with the AOV integrators of `render.integrators`).

Conventions that differ from the reference on purpose:
  * scene tensors carry a leading variant axis B (one geometry per variant),
    in place of `vmap`;
  * randomness comes from explicit `torch.Generator`s, one per variant;
  * geometry is float32 throughout and TF32 is off for matmuls and cuDNN —
    the counterpart of `utils/math.py::_mm`'s `precision=HIGHEST`.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from fireflies_tpu_torch import (  # noqa: E402, F401
    emitter,
    entity,
    graphics,
    material,
    projection,
    sampling,
    utils,
)
from fireflies_tpu_torch.emitter import Light  # noqa: E402
from fireflies_tpu_torch.entity import Curve, Mesh, Transformable  # noqa: E402
from fireflies_tpu_torch.material import Material  # noqa: E402
from fireflies_tpu_torch.scene import Scene  # noqa: E402


def load_scene(path):
    """Load a YAML scene description; returns (Scene, bridge_kwargs)."""
    from fireflies_tpu_torch.scene_io import load_scene as _load  # noqa: PLC0415

    return _load(path)


__all__ = [
    "Scene",
    "Mesh",
    "Transformable",
    "Curve",
    "Light",
    "Material",
    "load_scene",
    "sampling",
    "utils",
    "entity",
    "emitter",
    "material",
    "graphics",
    "projection",
    "__version__",
]
