"""Port parity for the dataset farm (`datagen/`, `utils/png.py`, the
`PostProcessor` classes) and a CPU run of bench's `datagen` row.

  * `generate_dataset` fed the same deterministic stub of render_batch_fn
    (frames made with numpy from the steps alone, some empty, some with too
    many components) in both packages: the same frames accepted and every
    PNG file byte-identical, also after a resume;
  * `connected_components` (scipy.ndimage.label) equals the flood fill it
    replaces and the reference's count on seeded masks; `write_png` /
    `read_png` give the reference's bytes and round-trip; `tonemap` and
    `to_grayscale` within 1e-6;
  * `GaussianBlur` equals the reference's (1e-6), the batched
    `gaussian_blur2d` equals its per-image form bit for bit, and
    `PostProcessor`, `WhiteNoise` and `ApplySilhouette` keep their ranges;
  * `bench.measure_datagen(device="cpu")` at a tiny film prints a
    well-formed line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu import datagen as jx_datagen
from fireflies_tpu import postprocessing as jx_post
from fireflies_tpu.utils import png as jx_png
from fireflies_tpu_torch import bench, datagen
from fireflies_tpu_torch import postprocessing as tc_post
from fireflies_tpu_torch.utils import png as tc_png

torch.set_num_threads(2)

H, W = 24, 32


def _frame(step: int):
    """(image (H, W, 3), segmentation (H, W)) of one step: steps 0, 4, ...
    empty, 1, 5, ... five blobs (both rejected), the others one or two."""
    rng = np.random.default_rng(step)
    img = rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
    seg = np.zeros((H, W), np.int32)
    blobs = [0, 5, 1, 2][step % 4]
    for k in range(blobs):
        y, x = 4 * k + 1, rng.integers(0, W - 4)
        seg[y:y + 3, x:x + 4] = 1 + k % 2
    return img, seg


def _stub(steps):
    frames = [_frame(int(s)) for s in np.asarray(steps)]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.png"))}


def test_generate_dataset_matches_reference_bytes(tmp_path):
    jx_fn = lambda keys, steps: tuple(jnp.asarray(x) for x in _stub(steps))  # noqa: E731
    tc_fn = lambda seeds, steps: tuple(torch.from_numpy(x) for x in _stub(steps))  # noqa: E731
    jx_dir, tc_dir = tmp_path / "jax", tmp_path / "torch"
    for n_frames in (3, 5):  # the second call resumes after the first's frames
        got_j = jx_datagen.generate_dataset(jx_fn, n_frames, jx_dir, jax.random.key(0), batch=4)
        got_t = datagen.generate_dataset(tc_fn, n_frames, tc_dir, seed=0, batch=4)
        assert got_j == got_t == n_frames
        files = _files(tc_dir)
        assert len(files) == 2 * n_frames and files == _files(jx_dir)
    first = tc_png.read_png(str(tc_dir / "images" / "00000.png"))  # step 2's frame
    expect = (np.clip(_frame(2)[0], 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(first, expect)
    assert datagen.generate_dataset(tc_fn, 6, tmp_path / "cap", batch=4, max_dispatches=1) == 2


def test_components_png_tonemap_grayscale_match(tmp_path):
    rng = np.random.default_rng(7)
    for density in (0.2, 0.45, 0.6):
        mask = rng.uniform(size=(37, 41)) < density
        n = datagen.connected_components(mask)
        assert n > 1
        assert n == datagen.connected_components_plain(mask)
        assert n == jx_datagen.connected_components(mask)
    assert datagen.connected_components(np.zeros((5, 5), bool)) == 0

    rgb = rng.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    gray8 = (rng.uniform(size=(7, 5)) * 255).astype(np.uint8)
    for name, img in (("rgb", rgb), ("gray", gray8)):
        tc_png.write_png(str(tmp_path / f"t_{name}.png"), img)
        jx_png.write_png(str(tmp_path / f"j_{name}.png"), img)
        t_bytes = (tmp_path / f"t_{name}.png").read_bytes()
        assert t_bytes == (tmp_path / f"j_{name}.png").read_bytes()
    np.testing.assert_array_equal(tc_png.read_png(str(tmp_path / "t_gray.png")), gray8)
    assert tc_png.read_png(str(tmp_path / "t_rgb.png")).shape == (9, 11, 3)

    hdr = rng.uniform(0.0, 4.0, (6, 8, 3)).astype(np.float32)
    for exposure in (1.0, 0.5):
        np.testing.assert_allclose(datagen.tonemap(torch.from_numpy(hdr), exposure).numpy(),
                                   np.asarray(jx_datagen.tonemap(hdr, exposure)), rtol=1e-6)
    np.testing.assert_allclose(datagen.to_grayscale(torch.from_numpy(hdr)).numpy(),
                               np.asarray(jx_datagen.to_grayscale(hdr)), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    assert {datagen.spp_buckets(gen, (1, 4)) for _ in range(32)} == {1, 4}


def test_postprocessors():
    rng = np.random.default_rng(8)
    imgs = rng.uniform(size=(3, 20, 24, 3)).astype(np.float32)
    blur = tc_post.GaussianBlur((5, 3), (1.5, 0.8))
    ref = jx_post.GaussianBlur((5, 3), (1.5, 0.8)).apply(jax.random.key(0), jnp.asarray(imgs[0]))
    gen = torch.Generator().manual_seed(0)
    one = blur.apply(gen, torch.from_numpy(imgs[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    batched = tc_post.gaussian_blur2d(torch.from_numpy(imgs), (3, 3), (0.8, 0.8))
    for b in range(3):
        assert torch.equal(batched[b], tc_post.gaussian_blur2d(torch.from_numpy(imgs[b]), (3, 3),
                                                               (0.8, 0.8)))

    image = torch.from_numpy(imgs[1])
    assert torch.equal(tc_post.WhiteNoise(std=0.3, probability=0.0).apply(gen, image), image)
    noisy = tc_post.WhiteNoise(std=0.3).apply(gen, image)
    assert noisy.min() >= 0 and noisy.max() <= 1 and not torch.equal(noisy, image)
    pipeline = tc_post.PostProcessor([tc_post.ApplySilhouette(), tc_post.WhiteNoise(std=0.01),
                                      tc_post.GaussianBlur()])
    out = pipeline.post_process(torch.Generator().manual_seed(1), image)
    again = pipeline.post_process(torch.Generator().manual_seed(1), image)
    assert out.shape == image.shape and torch.equal(out, again)
    vignette = tc_post.ApplySilhouette().apply(gen, torch.ones(40, 40))
    assert vignette.min() < 0.5 and vignette.max() > 0.9


def test_bench_measure_datagen_cpu_line():
    line = bench.measure_datagen(size=128, spp=1, resolution=8, batch=2, n_frames=2, device="cpu")
    assert set(line) == {"metric", "value", "unit", "detail"}
    assert line["metric"].startswith("128x128 dataset-farm frames/sec/chip (vocalfold ")
    assert line["unit"] == "frames/sec/chip" and np.isfinite(line["value"]) and line["value"] > 0
    detail = line["detail"]
    assert detail["frames_accepted"] == 2 and detail["static_geometry"] is False
    assert detail["dispatches"] >= 1 and 0 < detail["render_seconds"] <= detail["seconds"]
    assert detail["manifest"]["n_frames"] == 2 and len(detail["manifest"]["sha256"]) == 64
    assert detail["device"] == "cpu" and detail["peak_device_memory_gib"] is None
