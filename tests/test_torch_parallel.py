"""Port parity for `parallel/` and `datagen.generate_dataset_parallel`: two
gloo processes (`torch.multiprocessing.spawn`, a FileStore in tmp_path),
each one rank of a CPU mesh, against the same work done in one process:

  * `psum_grad_step` over `main_path.variant_loss` (vocalfold resolution 6,
    24x16, 2 bounces, 2 variants a rank from `shard_keys`): the loss and
    the (144, 3) beam gradient equal the one-process batch of all 4
    variants (1e-5 relative); `variant_parallel` and `all_gather_frames`
    return every rank's batch in rank order; a CUDA mesh under gloo is
    refused;
  * `render_tile_parallel` (2 bands of a 24x32 film): at pixel centres and
    one bounce it equals `render_rgb` of the whole film bit for bit; with
    draws, each band equals the one-process band render with that band's
    generators, also in a second call with the same generators, which draws
    anew in every band and leaves the ranks' generators equal;
    `dp_tile_grad_step` on a 1 x 2 mesh equals the gradient of the loss
    over the concatenated bands in one process;
  * `generate_dataset_parallel` (2 frames a rank a dispatch, a numpy stub
    for the render): the PNG files equal `generate_dataset`'s with a batch
    of 4, byte for byte;
  * a deterministic quadratic loss through the port's `psum_grad_step` on
    the two ranks against the JAX package's on a 2-device CPU mesh.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fireflies_tpu_torch import datagen, main_path, parallel
from fireflies_tpu_torch.render import RenderConfig, render_rgb
from fireflies_tpu_torch.utils.seeds import step_seeds

WORLD, PER_RANK = 2, 2
CFG = RenderConfig(width=24, height=16, spp=1, max_bounces=2, static_geometry=True)
BAND_CFG = CFG.replace(height=32, max_bounces=1)
FRAMES = 10


def _objective(img, aux):
    return (img * img).mean(dim=(1, 2, 3))


def _image_loss(img):
    return (img * img).mean(dim=(1, 2, 3))


def _stub(seeds, steps):
    """A numpy render_batch_fn: images from each seed, a 3x3 blob in the
    segmentation unless the seed is a multiple of 3 (rejected as empty)."""
    images, segs = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        images.append(rng.random((8, 8, 3), dtype=np.float32))
        seg = np.zeros((8, 8), np.int32)
        if seed % 3:
            seg[2:5, 1:4] = 1
        segs.append(seg)
    return torch.from_numpy(np.stack(images)), torch.from_numpy(np.stack(segs))


def _quadratic(params, targets):
    """(B,) losses sum((w - target)^2), one a target row."""
    return ((params["w"] - targets) ** 2).sum(-1)


def _worker(rank, store, out, targets):
    torch.set_num_threads(1)
    parallel.init_distributed(rank, WORLD, "cpu", store_path=store)
    try:
        res = {}
        mesh = parallel.make_mesh(WORLD, device="cpu")
        try:
            parallel.make_mesh(device="cuda")
        except ValueError:
            res["refused"] = True
        bridge, randomize, beams = main_path.build("cpu", resolution=6)
        loss_fn = main_path.variant_loss(bridge, randomize, CFG, _objective)
        gens = parallel.shard_keys(mesh, 0, PER_RANK)
        res["psum"] = parallel.psum_grad_step(lambda rays, g: loss_fn(rays, g, 0), mesh)(
            beams, gens)
        run = parallel.variant_parallel(
            lambda g, steps: (torch.stack([torch.rand(3, generator=x) for x in g]),
                              torch.tensor(steps) + 10 * rank), mesh)
        res["variant_parallel"] = run(parallel.shard_keys(mesh, 1, PER_RANK), [rank, rank])
        res["frames"] = parallel.all_gather_frames(mesh, torch.full((PER_RANK, 2), float(rank)))
        res["quadratic"] = parallel.psum_grad_step(_quadratic, mesh)(
            {"w": torch.tensor([1.0, -2.0, 0.5])},
            torch.from_numpy(targets[rank * PER_RANK:(rank + 1) * PER_RANK]))

        tiles = parallel.make_mesh(axis_name=parallel.TILE_AXIS, device="cpu")
        scene = main_path.scene_batch(bridge, randomize, beams, main_path.generators([3], "cpu"))
        res["bands_centres"] = parallel.render_tile_parallel(scene, None, BAND_CFG, tiles)
        gens = main_path.generators([4], "cpu")
        res["bands_drawn"], res["bands_again"] = [parallel.render_tile_parallel(
            scene, gens, BAND_CFG.replace(max_bounces=2), tiles) for _ in range(2)]
        res["gens_state"] = gens[0].get_state()
        mesh2 = parallel.make_mesh_2d(1, WORLD, device="cpu")
        step = parallel.dp_tile_grad_step(
            lambda b, g: main_path.scene_batch(bridge, randomize, b, g), _image_loss,
            BAND_CFG, mesh2)
        res["dp_tile"] = step(beams, parallel.shard_keys(mesh2, 5, 1))

        res["farm"] = datagen.generate_dataset_parallel(_stub, FRAMES, out / "farm", 0, mesh,
                                                        per_device=PER_RANK)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, the JAX targets and the output directory."""
    import jax  # noqa: PLC0415

    out = tmp_path_factory.mktemp("parallel")
    keys = jax.random.split(jax.random.key(0), WORLD * PER_RANK)
    targets = np.stack([np.asarray(jax.random.uniform(k, (3,))) for k in keys])
    mp.spawn(_worker, args=(str(out / "store"), out, targets), nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)], targets, out


def test_psum_grad_step_and_gathers_match_one_process(ranks):
    results, _, _ = ranks
    bridge, randomize, beams = main_path.build("cpu", resolution=6)
    loss_fn = main_path.variant_loss(bridge, randomize, CFG, _objective)
    leaf = beams.detach().requires_grad_(True)
    seeds = step_seeds(0, 0, WORLD * PER_RANK)
    loss = loss_fn(leaf, main_path.generators(seeds, "cpu"), 0).mean()
    loss.backward()
    for res in results:
        assert res["refused"]
        torch.testing.assert_close(res["psum"][0], loss.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(res["psum"][1], leaf.grad, rtol=1e-5,
                                   atol=1e-5 * float(leaf.grad.abs().max()))
        draws, steps = res["variant_parallel"]
        gens = main_path.generators(step_seeds(1, 0, WORLD * PER_RANK), "cpu")
        torch.testing.assert_close(draws, torch.stack([torch.rand(3, generator=g) for g in gens]))
        assert steps.tolist() == [0, 0, 11, 11]
        assert res["frames"][:, 0].tolist() == [0.0, 0.0, 1.0, 1.0]


def test_band_parallel_matches_one_process(ranks):
    results, _, _ = ranks
    bridge, randomize, beams = main_path.build("cpu", resolution=6)
    scene_3 = main_path.scene_batch(bridge, randomize, beams, main_path.generators([3], "cpu"))
    whole = render_rgb(scene_3, None, BAND_CFG)
    bh = BAND_CFG.height // WORLD

    def band(t, cfg, s, gens):
        return render_rgb(s, parallel._band_generators(gens, t, WORLD), cfg.replace(height=bh),
                          film_y0=t * bh, film_full_height=cfg.height)

    def two_calls(t):  # rank t's own generators, reused by a second call
        gens = main_path.generators([4], "cpu")
        return [band(t, BAND_CFG.replace(max_bounces=2), scene_3, gens) for _ in range(2)]

    calls = [two_calls(t) for t in range(WORLD)]
    drawn, again = (torch.cat([c[i] for c in calls], 1) for i in range(2))
    for t in range(WORLD):  # every band draws anew when the generators are reused
        assert not torch.equal(drawn[:, t * bh:(t + 1) * bh], again[:, t * bh:(t + 1) * bh])
    leaf = beams.detach().requires_grad_(True)

    def dp_band(t):  # each rank randomizes the variant from fresh generators
        gens = main_path.generators(step_seeds(5, 0, 1), "cpu")
        return band(t, BAND_CFG, main_path.scene_batch(bridge, randomize, leaf, gens), gens)

    loss = _image_loss(torch.cat([dp_band(t) for t in range(WORLD)], 1)).mean()
    loss.backward()
    for res in results:
        torch.testing.assert_close(res["bands_centres"], whole, rtol=0, atol=0)
        torch.testing.assert_close(res["bands_drawn"], drawn, rtol=0, atol=0)
        torch.testing.assert_close(res["bands_again"], again, rtol=0, atol=0)
        assert torch.equal(res["gens_state"], results[0]["gens_state"])  # ranks still agree
        torch.testing.assert_close(res["dp_tile"][0], loss.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(res["dp_tile"][1], leaf.grad, rtol=1e-5,
                                   atol=1e-5 * float(leaf.grad.abs().max()))
    assert leaf.grad.abs().max() > 0


def test_generate_dataset_parallel_writes_the_same_files(ranks, tmp_path):
    results, _, out = ranks
    n = datagen.generate_dataset(_stub, FRAMES, tmp_path, seed=0, batch=WORLD * PER_RANK)
    assert n == FRAMES and [res["farm"] for res in results] == [FRAMES] * WORLD
    for sub in ("images", "segmentations"):
        names = sorted(p.name for p in (tmp_path / sub).iterdir())
        assert names == sorted(p.name for p in (out / "farm" / sub).iterdir())
        assert len(names) == FRAMES
        for name in names:
            assert (out / "farm" / sub / name).read_bytes() == (tmp_path / sub / name).read_bytes()


def test_psum_grad_step_matches_the_reference(ranks):
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    from fireflies_tpu import parallel as jx_parallel  # noqa: PLC0415

    results, _, _ = ranks
    mesh = jx_parallel.make_mesh(WORLD)

    def loss_fn(params, key):
        return jnp.sum((params["w"] - jax.random.uniform(key, (3,))) ** 2)

    keys = jax.random.split(jax.random.key(0), WORLD * PER_RANK)
    loss, grad = jx_parallel.psum_grad_step(loss_fn, mesh)({"w": jnp.asarray([1.0, -2.0, 0.5])},
                                                           keys)
    for res in results:
        t_loss, t_grad = res["quadratic"]
        np.testing.assert_allclose(t_loss.numpy(), np.asarray(loss), rtol=1e-6)
        np.testing.assert_allclose(t_grad["w"].numpy(), np.asarray(grad["w"]), rtol=1e-6,
                                   atol=1e-7)
