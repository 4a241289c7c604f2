from fireflies_tpu_torch.utils import intersections, math  # noqa: F401
