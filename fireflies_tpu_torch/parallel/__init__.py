"""Scale-out across devices: variant-parallel rendering, film bands and
averaged gradient steps (port of fireflies_tpu/parallel).

The reference lays a `jax.sharding.Mesh` over the TPU slice and runs each
function under `shard_map`, one program for all devices.  Here every device
has a process of its own (`torch.distributed`, one rank a device): each
rank calls the same function on its share, and the collectives are explicit
(`all_reduce` for the means, `all_gather` for frames and film bands).  The
backend follows the device: NCCL for CUDA tensors, gloo for CPU tensors,
and a mesh whose device does not fit the process group's backend is an
error, never a quiet switch (`init_distributed` starts the group; the
caller gives it the address, world size and rank).

Where a JAX function takes keys split across the mesh, its counterpart here
takes this rank's own torch.Generators (`shard_keys`), and where the JAX
function returns a global array sharded over the mesh, its counterpart
returns the gathered tensor on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from fireflies_tpu_torch.render.rays import HostDraws
from fireflies_tpu_torch.utils.seeds import step_seeds

Tensor = torch.Tensor

DATA_AXIS = "variants"
TILE_AXIS = "tiles"


def backend_for(device) -> str:
    """The process group's backend for `device`: NCCL on a card, gloo on
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(rank: int, world_size: int, device, init_method: Optional[str] = None,
                     store_path: Optional[str] = None) -> None:
    """Start this process's group with the backend of `device`: by
    `init_method` (for example "tcp://localhost:29500") or through a
    FileStore at `store_path` that every rank shares."""
    backend = backend_for(device)
    if store_path is not None:
        store = dist.FileStore(str(store_path), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)


@dataclasses.dataclass
class Mesh:
    """The ranks of the process group as a grid with named axes: `shape`
    maps each axis name to its size, `coords` gives this rank's index along
    each axis, and `groups` its process group along each (None for the
    whole world)."""

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def _mesh_device(device) -> torch.device:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or "
                           "torch.distributed.init_process_group) on every rank first")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if backend_for(device) != backend:
        raise ValueError(f"a {device.type} mesh needs the {backend_for(device)} backend, "
                         f"the process group runs {backend}")
    return device


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS, device=None) -> Mesh:
    """A 1-D mesh over every rank (`n_devices`, when given, must be the
    world size: each rank is one device).  `device`: this rank's device
    (default the current card under NCCL, the CPU under gloo)."""
    device = _mesh_device(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks, have {world}")
    return Mesh((axis_name,), {axis_name: world}, {axis_name: dist.get_rank()},
                {axis_name: None}, device)


def make_mesh_2d(n_variants: int, n_tiles: int, var_axis: str = DATA_AXIS,
                 tile_axis: str = TILE_AXIS, device=None) -> Mesh:
    """A 2-D mesh: variant data-parallel x film-band parallel, rank
    v * n_tiles + t at (v, t).  The film bands gather along the tile axis
    (the consecutive ranks, where a host's links are fastest); the variant
    axis carries only the gradient's mean.  Every rank builds every
    sub-group (`dist.new_group` is collective)."""
    device = _mesh_device(device)
    world = dist.get_world_size()
    if world != n_variants * n_tiles:
        raise ValueError(f"need {n_variants * n_tiles} ranks, have {world}")
    rank = dist.get_rank()
    v, t = divmod(rank, n_tiles)
    groups = {}
    for i in range(n_variants):
        g = dist.new_group([i * n_tiles + j for j in range(n_tiles)])
        if i == v:
            groups[tile_axis] = g
    for j in range(n_tiles):
        g = dist.new_group([i * n_tiles + j for i in range(n_variants)])
        if j == t:
            groups[var_axis] = g
    return Mesh((var_axis, tile_axis), {var_axis: n_variants, tile_axis: n_tiles},
                {var_axis: v, tile_axis: t}, groups, device)


def shard_keys(mesh: Mesh, seed: int, per_device: int,
               axis_name: str = DATA_AXIS) -> list[torch.Generator]:
    """This rank's `per_device` generators on the mesh's device: of the
    n = mesh.shape[axis_name] * per_device generators of the whole axis,
    seeded `utils.seeds.step_seeds(seed, 0, n)`, the ones at this rank's
    index along the axis (the reference splits one key and shards it)."""
    n = mesh.shape[axis_name] * per_device
    lo = mesh.coords[axis_name] * per_device
    return [torch.Generator(device=mesh.device).manual_seed(s)
            for s in step_seeds(seed, 0, n)[lo:lo + per_device]]


def _gather(x: Tensor, mesh: Mesh, axis_name: str, dim: int = 0) -> Tensor:
    """`x` of every rank along the axis, concatenated on `dim` in rank
    order; differentiable (each rank's share of the gradient sent back to
    it, summed over the ranks that used it) when x requires grad."""
    group = mesh.groups[axis_name]
    if mesh.shape[axis_name] == 1:
        return x
    if x.requires_grad:
        import torch.distributed.nn.functional as dist_nn  # noqa: PLC0415

        parts = dist_nn.all_gather(x.contiguous(), group=group or dist.group.WORLD)
    else:
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis_name])]
        dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(list(parts), dim=dim)


def _mean_over(x: Tensor, mesh: Mesh, axis_name: str) -> Tensor:
    if mesh.shape[axis_name] > 1:
        x = x.clone()
        dist.all_reduce(x, group=mesh.groups[axis_name])
        x = x / mesh.shape[axis_name]
    return x


def variant_parallel(fn: Callable, mesh: Mesh, axis_name: str = DATA_AXIS) -> Callable:
    """Lift fn(gens, steps) -> a batch (a tensor or a tuple of tensors with
    a leading variant axis) into run(gens, steps) over the mesh: each rank
    renders its own generators and steps in one batch, and every rank gets
    the whole axis's batch back, in rank order (`all_gather_frames`).  The
    reference vmaps a per-key fn under shard_map; the port's functions take
    a batch of variants already."""

    def run(gens, steps):
        out = fn(gens, steps)
        if isinstance(out, tuple):
            return tuple(all_gather_frames(mesh, x, axis_name) for x in out)
        return all_gather_frames(mesh, out, axis_name)

    return run


def _leaves(params):
    if isinstance(params, dict):
        return list(params.values())
    if isinstance(params, (list, tuple)):
        return list(params)
    return [params]


def _rebuild(params, leaves):
    if isinstance(params, dict):
        return dict(zip(params.keys(), leaves))
    if isinstance(params, (list, tuple)):
        return type(params)(leaves)
    return leaves[0]


def psum_grad_step(loss_fn: Callable, mesh: Mesh, axis_name: str = DATA_AXIS) -> Callable:
    """A data-parallel gradient step: step(params, gens) -> (mean_loss,
    mean_grad).  loss_fn(params, gens) gives this rank's losses, one a
    generator ((B,), or a scalar); each rank takes the gradient of its mean
    and the losses and gradients are averaged over the axis with
    `all_reduce`, so every rank returns the mean over the axis's variants
    (equal shares a rank).  `params`: a tensor, a list or tuple, or a dict
    of tensors; the gradient has its structure.  The reference takes
    value_and_grad per key under shard_map and pmeans."""

    def step(params, gens):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        loss = loss_fn(_rebuild(params, leaves), gens).mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return (_mean_over(loss.detach(), mesh, axis_name),
                _rebuild(params, [_mean_over(g, mesh, axis_name) for g in grads]))

    return step


def _band_generators(gens, band: int, n_bands: int):
    """The generators of film band `band` of `n_bands`.  One band keeps the
    caller's, so that a one-band render is render_rgb's.  With more, each
    caller's generator draws one seed, and band k draws from a generator
    seeded step_seeds(seed, k, 1): every rank draws the same seed (its
    generators are the same), the bands are decorrelated (the reference
    folds the band index into its key), and the caller's generators move
    on by that one draw on every rank, so a second call draws anew."""
    if gens is None or n_bands == 1:
        return gens
    out = []
    for g in gens:
        seed = int(torch.randint(2**62, (1,), generator=g, device=g.device))
        out.append(torch.Generator(device=g.device).manual_seed(step_seeds(seed, band, 1)[0]))
    return HostDraws(out) if isinstance(gens, HostDraws) else out


def _band_config(config, n_bands: int):
    if config.height % n_bands:
        raise ValueError(f"height {config.height} not divisible by {n_bands} bands")
    return config.replace(height=config.height // n_bands)


def render_tile_parallel(scene, gens, config, mesh: Mesh, axis_name: str = TILE_AXIS) -> Tensor:
    """One render with its pixel rows split across a mesh axis: the rank at
    index t renders the config.height / n-row band from row t * bh
    (render_rgb's film_y0 / film_full_height, `_band_generators`' draws),
    and the bands are gathered into the (B, H, W, 3) image on every rank.
    Not with config.reparam (the warp samples the whole film)."""
    from fireflies_tpu_torch.render.pathtracer import render_rgb  # noqa: PLC0415

    nt = mesh.shape[axis_name]
    band_cfg = _band_config(config, nt)
    ti = mesh.coords[axis_name]
    band = render_rgb(scene, _band_generators(gens, ti, nt), band_cfg,
                      film_y0=ti * band_cfg.height, film_full_height=config.height)
    return _gather(band, mesh, axis_name, dim=1)


def dp_tile_grad_step(scene_fn: Callable, image_loss: Callable, config, mesh: Mesh,
                      var_axis: str = DATA_AXIS, tile_axis: str = TILE_AXIS) -> Callable:
    """A training step on a 2-D (variants x tiles) mesh: step(params, gens)
    -> (loss, grad), the mean of image_loss over every variant of the mesh
    and its gradient with respect to `params` (a tensor, list, tuple or
    dict of tensors).

    scene_fn(params, gens) builds this variant group's batched RenderScene
    (one variant a generator; every rank of a tile group gets the same
    generators from `shard_keys` along the variant axis);
    image_loss(images (B, H, W, 3)) -> (B,).  Each rank renders its band of
    its group's frames, the bands are gathered with autograd
    (`torch.distributed.nn.functional.all_gather`), and each rank of the
    group evaluates the loss on the whole images.  The gather's backward
    sums the band cotangents over the group's ranks, so each rank
    back-propagates its loss over the group's size; the parameters'
    gradients from the bands are then summed over the tile axis and
    averaged over the variant axis.  The reference keeps the loss and its
    autodiff global and lets shard_map's transpose insert these
    collectives."""
    from fireflies_tpu_torch.render.pathtracer import render_rgb  # noqa: PLC0415

    nt = mesh.shape[tile_axis]
    band_cfg = _band_config(config, nt)
    ti = mesh.coords[tile_axis]

    def step(params, gens):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        scene = scene_fn(_rebuild(params, leaves), gens)
        band = render_rgb(scene, _band_generators(gens, ti, nt), band_cfg,
                          film_y0=ti * band_cfg.height, film_full_height=config.height)
        loss = image_loss(_gather(band, mesh, tile_axis, dim=1)).mean()
        grads = torch.autograd.grad(loss / nt, leaves, allow_unused=True)
        out = []
        for p, g in zip(leaves, grads):
            g = torch.zeros_like(p) if g is None else g.clone()
            if nt > 1:
                dist.all_reduce(g, group=mesh.groups[tile_axis])
            out.append(_mean_over(g, mesh, var_axis))
        return _mean_over(loss.detach(), mesh, var_axis), _rebuild(params, out)

    return step


def all_gather_frames(mesh: Mesh, frames: Tensor, axis_name: str = DATA_AXIS) -> Tensor:
    """Every rank's frame batch along the axis, concatenated in rank order
    on every rank (dataset collection)."""
    return _gather(frames, mesh, axis_name, dim=0)
