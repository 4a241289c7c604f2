"""Hand-written CUDA intersection kernels with their plain PyTorch versions
(counterpart of fireflies_tpu/render/pallas)."""

from fireflies_tpu_torch.render.cuda import (
    intersect_culled,
    intersect_general_culled,
    intersect_kernel,
    intersect_stream,
)

# Every kernel a render path launches, by the name chip_smoke.py reports.
KERNELS = {
    "intersect_shared_culled": intersect_culled.KERNEL,
    "intersect_general": intersect_kernel.KERNEL,
    "intersect_stream_culled": intersect_stream.KERNEL,
    "intersect_stream_general_culled": intersect_stream.KERNEL_GENERAL,
    "intersect_general_culled": intersect_general_culled.KERNEL,
    "intersect_shared": intersect_kernel.KERNEL_SHARED,
    "intersect_stream": intersect_stream.KERNEL_UNCULLED,
    "intersect_stream_general": intersect_stream.KERNEL_UNCULLED_GENERAL,
}

__all__ = ["KERNELS", "intersect_culled", "intersect_general_culled", "intersect_kernel",
           "intersect_stream"]
