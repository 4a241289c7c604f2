"""Dataset generation: the reference's production loop, batched (port of
fireflies_tpu/datagen).

One call of `render_batch_fn` randomizes, renders, segments and
post-processes a batch of candidate frames on the device; the rejection
filter (an empty segmentation, too many connected components) runs on the
host over the batch, and the accepted frames are written as PNG files.
Resume is by frame count: running again on the same out_dir continues after
the last saved index.  `generate_dataset_parallel` spreads each dispatch
over the ranks of a `parallel` mesh; rank 0 gathers, filters and writes.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from scipy import ndimage

from fireflies_tpu_torch import native
from fireflies_tpu_torch.utils.png import write_png
from fireflies_tpu_torch.utils.seeds import step_seeds

Tensor = torch.Tensor


def connected_components(mask: np.ndarray) -> int:
    """Number of 4-connected components of a binary mask: the native
    library's flood fill (`native.connected_components`), as in the JAX
    package, or under FIREFLIES_NO_NATIVE=1 `scipy.ndimage.label` with its
    default (4-connected) structure."""
    if native.enabled():
        return native.connected_components(mask)
    return int(ndimage.label(np.asarray(mask, bool))[1])


def connected_components_plain(mask: np.ndarray) -> int:
    """The reference's flood fill: the plain version connected_components
    is held to (about a second for a 512x512 frame)."""
    mask = np.asarray(mask, bool)
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    current = 0
    stack: list[tuple[int, int]] = []
    for sy in range(h):
        for sx in range(w):
            if mask[sy, sx] and labels[sy, sx] == 0:
                current += 1
                stack.append((sy, sx))
                labels[sy, sx] = current
                while stack:
                    y, x = stack.pop()
                    for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                        if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and labels[ny, nx] == 0:
                            labels[ny, nx] = current
                            stack.append((ny, nx))
    return current


@dataclasses.dataclass
class RejectionConfig:
    """Data-quality filters of the reference main loop."""

    min_coverage: float = 0.001  # non-empty segmentation
    max_components: int = 3
    target_mesh_id: Optional[int] = None  # component check on one mesh's mask


def default_frame_filter(rejection: RejectionConfig) -> Callable[[np.ndarray], bool]:
    def keep(seg: np.ndarray) -> bool:
        mask = seg == rejection.target_mesh_id if rejection.target_mesh_id else seg > 0
        if mask.mean() < rejection.min_coverage:
            return False
        return connected_components(mask) <= rejection.max_components

    return keep


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def generate_dataset(render_batch_fn: Callable[[list, list], tuple], n_frames: int,
                     out_dir: str | os.PathLike, seed: int = 0, batch: int = 8,
                     rejection: RejectionConfig | None = None,
                     max_dispatches: Optional[int] = None) -> int:
    """Produce `n_frames` accepted (image, segmentation) pairs in
    out_dir/images and out_dir/segmentations.

    render_batch_fn(seeds, steps) -> (images (B, H, W[, C]) in [0, 1],
    segmentations (B, H, W)), one frame per (seed, step); a dispatch's
    steps follow on from the frames already present, and the frame at
    step s is seeded step_seeds(seed, s, 1)[0].  Each dispatch is read back
    to the host before its frames are filtered and written.

    Resumes from the frames in out_dir.  Returns the number of frames now
    present.
    """
    return _farm(render_batch_fn, n_frames, Path(out_dir), seed, batch, rejection,
                 max_dispatches, writer=True, agree=lambda count: count)


def _farm(render_batch_fn, n_frames: int, out: Path, seed: int, batch: int,
          rejection: RejectionConfig | None, max_dispatches: Optional[int], writer: bool,
          agree: Callable[[int], int]) -> int:
    """generate_dataset's loop.  Only the `writer` reads out_dir, filters
    and writes; `agree(count)` gives every caller the writer's frame count,
    at the start and after each dispatch."""
    if writer:
        (out / "images").mkdir(parents=True, exist_ok=True)
        (out / "segmentations").mkdir(parents=True, exist_ok=True)
    keep = default_frame_filter(rejection or RejectionConfig())

    count = agree(len(list((out / "images").glob("*.png"))) if writer else 0)
    step_base = count
    dispatch = 0
    while count < n_frames:
        if max_dispatches is not None and dispatch >= max_dispatches:
            break
        steps = list(range(step_base + dispatch * batch, step_base + (dispatch + 1) * batch))
        images, segs = render_batch_fn([step_seeds(seed, s, 1)[0] for s in steps], steps)
        if writer:
            images, segs = _host(images), _host(segs)
            for i in range(batch):
                if count >= n_frames:
                    break
                if not keep(segs[i]):
                    continue
                write_png(str(out / "images" / f"{count:05d}.png"), images[i])
                seg_vis = (segs[i] > 0).astype(np.uint8) * 255
                write_png(str(out / "segmentations" / f"{count:05d}.png"), seg_vis)
                count += 1
        count = agree(count)
        dispatch += 1
    return count


def generate_dataset_parallel(render_batch_fn: Callable[[list, list], tuple], n_frames: int,
                              out_dir: str | os.PathLike, seed: int, mesh,
                              per_device: int = 4, rejection: RejectionConfig | None = None,
                              max_dispatches: Optional[int] = None) -> int:
    """generate_dataset spread over a `parallel` mesh: every rank calls it
    alike.  Each dispatch holds mesh.size * per_device frames; the rank at
    index r of the mesh renders frames r * per_device .. (r + 1) *
    per_device - 1 through render_batch_fn(seeds, steps), the ranks gather
    the batch (`parallel.all_gather_frames`), and rank 0 filters it and
    writes the PNG files exactly as generate_dataset would, then sends its
    frame count to the others.  The same frames as generate_dataset with
    batch = mesh.size * per_device.  Returns the frame count on every
    rank."""
    import torch.distributed as dist  # noqa: PLC0415

    from fireflies_tpu_torch import parallel  # noqa: PLC0415

    axis = mesh.axis_names[0]
    if len(mesh.axis_names) != 1:
        raise ValueError("generate_dataset_parallel takes a 1-D mesh")
    lo = mesh.coords[axis] * per_device

    def batched(seeds, steps):
        images, segs = render_batch_fn(seeds[lo:lo + per_device], steps[lo:lo + per_device])
        return (parallel.all_gather_frames(mesh, images.to(mesh.device), axis),
                parallel.all_gather_frames(mesh, segs.to(mesh.device), axis))

    def agree(count: int) -> int:
        t = torch.tensor([count], dtype=torch.int64, device=mesh.device)
        dist.broadcast(t, src=0)
        return int(t.item())

    return _farm(batched, n_frames, Path(out_dir), seed, mesh.size * per_device,
                 rejection, max_dispatches, writer=dist.get_rank() == 0, agree=agree)


def spp_buckets(gen: torch.Generator, buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)) -> int:
    """The spp of the next dispatch, one bucket drawn uniformly from `gen`
    (the reference draws spp per frame from U[1, 100]; a dispatch renders
    its whole batch at one spp)."""
    return int(buckets[int(torch.randint(len(buckets), (), generator=gen, device=gen.device))])


def tonemap(img: Tensor, exposure: float = 1.0) -> Tensor:
    """Reinhard tonemap x / (1 + x) of the exposed image, clipped to [0, 1]."""
    x = img * exposure
    return (x / (1.0 + x)).clamp(0.0, 1.0)


def to_grayscale(img: Tensor) -> Tensor:
    """Rec. 709 luma of an (H, W, 3) image; other images pass through."""
    if img.dim() == 3 and img.shape[-1] == 3:
        return 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    return img
