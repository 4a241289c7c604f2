"""Laser pattern initialization (port of fireflies_tpu/estimation)."""

from fireflies_tpu_torch.estimation.laser_estimation import (  # noqa: F401
    LaserConfig,
    generate_epipolar_constraints,
    initialize_laser,
    laser_from_ndc_points,
    points_from_probability_distribution,
    probability_distribution_from_depth_maps,
)
