"""2D graphics: differentiable point and line rasterization."""

from fireflies_tpu_torch.graphics.rasterization import (  # noqa: F401
    rasterize_depth,
    rasterize_lines,
    rasterize_points,
    rasterize_points_in_non_ndc,
    softor,
    softor_points,
    subsampled_point_raster,
    sum_,
    sum_points,
)
