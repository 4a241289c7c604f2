from fireflies_tpu_torch.projection.camera import (  # noqa: F401
    Camera,
    directions_to_ndc,
    ndc_to_directions,
    points_to_ndc,
)
from fireflies_tpu_torch.projection.laser import Laser  # noqa: F401
