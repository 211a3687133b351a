"""The port's training data, registry and grids against the JAX package's,
on the CPU: the CycleGAN history pool, the paired and unpaired datasets
(PNGs written here with PIL), the run registry and the per-epoch grids.

The datasets resize with the port's copy of Pillow's bilinear resample and
take Pillow's integer luma for ``"L"``, so their arrays equal JAX's exactly
(no 1-LSB slack is needed)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from lpr_tpu.data import datasets as jds
from lpr_tpu.data.image_pool import ImagePool as JPool
from lpr_tpu.utils import registry as jreg
from lpr_tpu_torch.data import datasets as tds
from lpr_tpu_torch.data.image_pool import ImagePool as TPool
from lpr_tpu_torch.utils import registry as treg

from .train_ref import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_image_pool_matches_jax(kind):
    """Pool of 3 fed 6 batches of 2: stores, swaps and pass-throughs
    follow the same random.Random(seed) history."""
    rng = np.random.RandomState(0)
    jp, tp = JPool(3, seed=1), TPool(3, seed=1)
    for _ in range(6):
        b = rng.rand(2, 4, 4, 3).astype(np.float32)
        ref = jp.query(b)
        got = tp.query(b if kind == "numpy" else torch.from_numpy(b))
        assert type(got) is (np.ndarray if kind == "numpy" else torch.Tensor)
        np.testing.assert_array_equal(np.asarray(got), ref)
    assert TPool(0).query(b) is b


def _write_pngs(folder, names, shape, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for n in names:
        Image.fromarray(rng.randint(0, 256, (*shape, 3), np.uint8)).save(
            os.path.join(folder, n), format="PNG")


@pytest.mark.parametrize("hr_gray", [True, False])
def test_paired_dataset_matches_jax(tmp_path, hr_gray):
    """Pairs by identical name (an LR without its HR is dropped), LR in
    RGB and HR in Pillow's "L" (or RGB), resized up and down; the batches
    in the same shuffled order."""
    hr, lr = str(tmp_path / "hr"), str(tmp_path / "lr")
    _write_pngs(hr, ["a.png", "b.png", "c.png"], (43, 389), 0)
    _write_pngs(lr, ["a.png", "b.png", "c.png", "lonely.png"], (20, 90), 1)
    for hw in ((32, 192), (16, 32)):
        j = jds.PairedImageDataset(hr, lr, hw, hr_gray=hr_gray)
        t = tds.PairedImageDataset(hr, lr, hw, hr_gray=hr_gray)
        assert t.pairs == j.pairs and len(t) == 3
        for (jl, jh), (tl, th) in zip(j.batches(2, seed=3),
                                      t.batches(2, seed=3)):
            assert th.shape == jh.shape and tl.dtype == np.float32
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(th, jh)


def test_unpaired_dataset_matches_jax(tmp_path):
    _write_pngs(tmp_path / "trainA", ["a0.png", "a1.png", "a2.png"],
                (40, 200), 2)
    _write_pngs(tmp_path / "trainB", ["b0.png", "b1.png"], (30, 150), 3)
    j = jds.UnpairedImageDataset(str(tmp_path), (32, 64), seed=5)
    t = tds.UnpairedImageDataset(str(tmp_path), (32, 64), seed=5)
    assert len(t) == len(j) == 3
    for (ja, jb), (ta, tb) in zip(j.batches(2), t.batches(2)):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        assert ta.min() >= -1.0 and ta.max() <= 1.0


def test_registry_fingerprint_and_manifest_layout_match_jax(tmp_path):
    """The same dirs give the same fingerprint, the manifests the same
    keys, and each package reads the other's runs (lineage across a
    resume)."""
    data = tmp_path / "data"
    (data / "sub").mkdir(parents=True)
    (data / "a.png").write_bytes(b"x" * 100)
    (data / "sub" / "b.png").write_bytes(b"y" * 7)
    dirs = [str(data), str(tmp_path / "missing")]
    assert treg.dataset_fingerprint(dirs) == jreg.dataset_fingerprint(dirs)
    assert (treg.dataset_fingerprint(dirs, max_files=1)
            == jreg.dataset_fingerprint(dirs, max_files=1))

    ck = tmp_path / "ck.npz"
    np.savez(ck, w=np.zeros(3))
    root = str(tmp_path / "runs")
    jrun = jreg.RunRegistry(root).new_run("p", {"lr": 1.0},
                                          dataset_dirs=[str(data)])
    jrun.log_artifact(str(ck), aliases=("latest", "best"), step=1)
    jrun.finish({"psnr": 30})
    # the port reads the JAX run and resumes from it
    reg = treg.RunRegistry(root)
    assert reg.resume_checkpoint("p") == str(ck)
    child = reg.new_run("p", {"lr": 1.0}, dataset_dirs=[str(data)],
                        resume_from=reg.load("p", "run-0000"))
    assert child.id == "p/run-0001"
    assert child.manifest["parent"] == {
        "run_id": "p/run-0000", "checkpoint": str(ck),
        "sha256": jrun.artifact("latest")["sha256"]}
    art = child.log_artifact(str(ck), aliases=("latest",), step=2)
    child.finish({"psnr": 31})
    with open(child.path) as f:
        tm = json.load(f)
    with open(jrun.path) as f:
        jm = json.load(f)
    assert tm.keys() == jm.keys()
    assert art.keys() == jm["artifacts"][0].keys()
    assert tm["dataset_fingerprint"] == jm["dataset_fingerprint"]
    # and the JAX registry reads the port's run back
    jback = jreg.RunRegistry(root).latest("p", with_artifact="latest")
    assert jback.id == "p/run-0001"
    assert jback.artifact("latest")["version"] == 0


def test_grids_match_jax_outside_the_titles(tmp_path):
    """LPSR and CycleGAN grids (cells resized by the port's Pillow bicubic)
    equal JAX's everywhere but in the title band's cells, where the port's
    bitmap font differs from PIL's; the PNGs read back equal."""
    from lpr_tpu.train import visualize as jv
    from lpr_tpu_torch import imageio
    from lpr_tpu_torch.train import visualize as tv

    rng = np.random.RandomState(7)
    lr = rng.rand(5, 32, 192, 3).astype(np.float32)
    sr = rng.rand(5, 32, 192, 1).astype(np.float32)
    hr = rng.rand(5, 64, 384, 1).astype(np.float32)
    rows = [[lr[i], sr[i], hr[i]] for i in range(2)]
    titles = ["Original LR", "Super-Resolved", "GT HR"]
    ref = jv.image_grid(rows, titles=titles)
    got = tv.image_grid(rows, titles=titles)
    assert got.shape == ref.shape and got.dtype == np.uint8
    pad, cw, header = 6, 384, 20
    outside = np.ones(got.shape[:2], bool)
    for c in range(3):
        outside[:header, pad + c * (cw + pad):pad + c * (cw + pad) + cw] = 0
    np.testing.assert_array_equal(got[outside], ref[outside])
    assert (got[:header][~outside[:header]] != 24).any()    # titles drawn
    np.testing.assert_array_equal(tv.image_grid(rows), jv.image_grid(rows))

    tv.save_lpsr_epoch_grid(str(tmp_path / "l" / "g.png"), lr, sr, lr)
    back = imageio.read_rgb(str(tmp_path / "l" / "g.png"))
    np.testing.assert_array_equal(
        back, tv.image_grid([[lr[i], sr[i], lr[i]] for i in range(4)],
                            titles=titles))
    x = rng.rand(1, 32, 64, 3).astype(np.float32) * 2 - 1
    tv.save_cyclegan_epoch_grid(str(tmp_path / "c.png"), x, x, x, x, x, x)
    assert imageio.read_rgb(str(tmp_path / "c.png")).shape == (
        2 * (64 + 6) + 6 + 20, 3 * (384 + 6) + 6, 3)
