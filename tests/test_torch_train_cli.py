"""The port's training CLIs on the CPU (``--device cpu``) at tiny sizes:
``train_lpsr`` with its run registry and ``--resume-run`` (the port's
mirror of ``tests/test_registry.py::test_train_lpsr_cli_writes_registry_
and_resumes``), ``create_lr`` against the JAX tool, ``train_cyclegan``'s
checkpoints, and ``bench_train_step``'s JSON line."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from lpr_tpu_torch.utils.registry import RunRegistry, file_sha256

from .train_ref import one_torch_thread  # noqa: F401

GAN = "checkpoints/cyclegan_real_g.npz"


def _pngs(folder, names, shape, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for n in names:
        Image.fromarray(rng.randint(0, 255, (*shape, 3), np.uint8)).save(
            os.path.join(folder, n), format="PNG")


def _lpsr_args(tmp_path):
    for seed, (split, kind) in enumerate([("tr", "hr"), ("tr", "lr"),
                                          ("va", "hr"), ("va", "lr")]):
        _pngs(tmp_path / split / kind, [f"p{i}.png" for i in range(4)],
              (16, 32), seed)
    return ["--hr-train-dir", str(tmp_path / "tr" / "hr"),
            "--lr-train-dir", str(tmp_path / "tr" / "lr"),
            "--hr-val-dir", str(tmp_path / "va" / "hr"),
            "--lr-val-dir", str(tmp_path / "va" / "lr"),
            "--width", "32", "--height", "16",
            "--batch-size", "2", "--epochs", "1",
            "--ckpt-dir", str(tmp_path / "ck"),
            "--runs-dir", str(tmp_path / "runs"), "--device", "cpu"]


def test_train_lpsr_cli_writes_registry_and_resumes(tmp_path, capsys):
    """A run with its dataset fingerprint and best/last artifacts; a
    second run with --resume-run warm-starts from the first's 'latest'
    checkpoint and records it as its parent; the JAX package loads the
    checkpoint."""
    import jax

    from lpr_tpu.models import lpsr as jlpsr
    from lpr_tpu.weights.checkpoint import load_params
    from lpr_tpu_torch.cli.train_lpsr import main

    from .train_ref import shapes

    args = _lpsr_args(tmp_path)
    main(args)
    reg = RunRegistry(str(tmp_path / "runs"))
    run0 = reg.latest("lpsr")
    assert run0 is not None and run0.id == "lpsr/run-0000"
    assert run0.manifest["dataset_fingerprint"]
    assert run0.artifact("latest")["sha256"] == file_sha256(
        str(tmp_path / "ck" / "last_model.npz"))
    assert run0.artifact("best")["sha256"] == file_sha256(
        str(tmp_path / "ck" / "best_model.npz"))
    assert "best_psnr" in run0.manifest["summary"]
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        shapes(jlpsr.lpsr_init, jlpsr.LPSRConfig()))
    jp = load_params(str(tmp_path / "ck" / "best_model.npz"), like)
    assert jax.tree.structure(jp) == jax.tree.structure(like)

    main(args + ["--resume-run"])
    out = capsys.readouterr().out
    assert "resumed weights from" in out
    run1 = reg.latest("lpsr")
    assert run1.id == "lpsr/run-0001"
    assert run1.manifest["parent"]["run_id"] == "lpsr/run-0000"
    assert run1.manifest["parent"]["checkpoint"] == run0.artifact(
        "latest")["path"]


@pytest.mark.parametrize("world", [None, "1"])
def test_train_lpsr_data_parallel_needs_the_env(tmp_path, monkeypatch,
                                                world):
    """--data-parallel without WORLD_SIZE above 1 raises, naming the env
    contract, before any run is opened (WORLD_SIZE=2:
    tests/test_torch_parallel.py)."""
    from lpr_tpu_torch.cli.train_lpsr import main

    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit, match="one process a card"):
        main(_lpsr_args(tmp_path) + ["--data-parallel"])
    assert not os.path.exists(tmp_path / "runs")


def test_create_lr_matches_jax_and_keeps_pairs(tmp_path):
    """Seed 1 routes the four crops classical, classical, GAN, GAN
    (np.random.RandomState(1)).  The GAN-only outputs (PNG on both sides)
    equal the JAX tool's within 1 LSB; the classical ones (torch's draws,
    not JAX's) keep the shape and range; every output keeps its HR's
    name, ``a.jpg`` holding PNG bytes where the JAX tool writes a JPEG, so
    PairedImageDataset pairs all four."""
    from lpr_tpu.cli.create_lr import main as jmain
    from lpr_tpu_torch import imageio
    from lpr_tpu_torch.cli.create_lr import main as tmain
    from lpr_tpu_torch.data.datasets import PairedImageDataset

    hr = tmp_path / "hr"
    hr.mkdir()
    Image.fromarray(np.random.RandomState(5).randint(
        0, 255, (40, 160, 3), np.uint8)).save(hr / "a.jpg", quality=95)
    _pngs(hr, ["b.png", "c.png", "d.png"], (40, 160), 4)
    common = ["--hr-dir", str(hr), "--gan-weights", GAN, "--width", "32",
              "--height", "8", "--batch", "4", "--seed", "1"]
    jmain(common + ["--out-dir", str(tmp_path / "jax")])
    tmain(common + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(hr))
    assert sorted(os.listdir(tmp_path / "port")) == names
    routes = np.random.RandomState(1).rand(4)
    assert list(routes <= 0.4) == [False, False, True, True]
    for name, gan_only in zip(names, routes <= 0.4):
        with open(tmp_path / "port" / name, "rb") as f:
            assert f.read(8) == imageio.PNG_SIGNATURE
        got = imageio.read_rgb(str(tmp_path / "port" / name))
        assert got.shape == (8, 32, 3)
        if gan_only:
            ref = np.asarray(Image.open(tmp_path / "jax" / name).convert(
                "RGB"))
            assert np.abs(got.astype(int) - ref).max() <= 1, name
    pairs = PairedImageDataset(str(hr), str(tmp_path / "port"), (8, 32))
    assert len(pairs) == 4
    lr, hr_ = next(pairs.batches(4, shuffle=False))
    assert lr.shape == (4, 8, 32, 3) and hr_.shape == (4, 8, 32, 1)


def test_train_cyclegan_cli_writes_checkpoints(tmp_path):
    """One epoch at 32x64 (the production generator and PatchGAN): both
    generators written as npz states that the JAX package's generator
    structure takes."""
    from lpr_tpu.models import cyclegan as jcg
    from lpr_tpu_torch.cli.train_cyclegan import main
    from lpr_tpu_torch.weights.checkpoint import load_state

    from .train_ref import jax_tree

    _pngs(tmp_path / "d" / "trainA", ["a0.png", "a1.png"], (40, 150), 6)
    _pngs(tmp_path / "d" / "trainB", ["b0.png", "b1.png"], (20, 90), 7)
    main(["--dataroot", str(tmp_path / "d"), "--width", "64", "--height",
          "32", "--batch-size", "2", "--epochs", "1", "--ckpt-every", "1",
          "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    for name in ("AtoB", "BtoA"):
        state, _ = load_state(str(tmp_path / "ck" /
                                  f"netG_{name}_epoch_1.npz"))
        assert all(np.isfinite(v).all() for v in state.values())
        jax_tree(jcg.generator_init, state, jcg.GeneratorConfig())


def test_bench_train_step_prints_json(capsys, monkeypatch):
    """The tool's lines on the CPU (det, then lpsr, as the JAX tool's
    default), the LPSR at batch 2 in place of 128 and the detector at
    batch 2 and 64x64 in place of 16 and 640x640."""
    from lpr_tpu_torch.tools import bench_train_step

    monkeypatch.setattr(bench_train_step, "LPSR_BATCH", 2)
    monkeypatch.setattr(bench_train_step, "DET_BATCH", 2)
    monkeypatch.setattr(bench_train_step, "DET_HW", (64, 64))
    assert bench_train_step.main(["--device", "cpu", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    det, rec = json.loads(lines[-2]), json.loads(lines[-1])
    assert rec["model"] == "lpsr_192x32_b2_f32"
    assert rec["peak_fraction"] is None and rec["device"].startswith("CPU")
    assert rec["flops_per_step"] > 0 and np.isfinite(rec["loss"])
    assert det["model"] == "det_yolov5s_nc11_64x64_b2_f32"
    assert det["flops_per_step"] > 0 and np.isfinite(det["loss"])
    assert det["device_busy_ms"] is None and det["top_kernels"] == []
