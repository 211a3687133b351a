"""The port's detector-training CLI and its utilities against the JAX
package's, on the CPU: ``cli/train_yolo`` end to end for one epoch on a
small PNG tree (with ``--autoanchor``, ``--evolve 1`` and ``--hyp``; the
run registry, ``results.csv``, ``hyp_evolve.yaml`` as ``yaml.safe_dump``
writes it), ``--data-parallel`` refused without ``WORLD_SIZE`` above 1
(``WORLD_SIZE=2`` is ``tests/test_torch_parallel.py``'s), and the
utilities ``evolve`` (mutation and CSV under a seed), ``kmeans_anchors``
and ``check_anchors``, ``StepGuard``, ``auto_resume_latest``, the loggers
and the hook registry, each equal to the JAX module's; and
``tools/bench_input``'s line and ``tools/synth``'s labels on the CPU."""

import csv
import os
import random

import numpy as np
import pytest
import torch
import yaml

from lpr_tpu.utils import autoanchor as jaa
from lpr_tpu.utils import evolve as jev
from lpr_tpu.utils import guards as jg
from lpr_tpu_torch.cli import train_yolo
from lpr_tpu_torch.imageio import write_png
from lpr_tpu_torch.utils import autoanchor as taa
from lpr_tpu_torch.utils import evolve as tev
from lpr_tpu_torch.utils import guards as tg
from lpr_tpu_torch.utils.callbacks import HOOKS, Callbacks
from lpr_tpu_torch.utils.loggers import CsvLogger, Loggers
from lpr_tpu_torch.weights.checkpoint import load_state

from .train_ref import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    imd, lbd = root / "images", root / "labels"
    imd.mkdir()
    lbd.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        write_png(str(imd / f"im{i}.png"),
                  (rng.rand(80, 96, 3) * 255).astype(np.uint8))
        with open(lbd / f"im{i}.txt", "w") as f:
            for _ in range(3):
                f.write(f"{rng.randint(0, 3)} {rng.uniform(.3, .7):.4f} "
                        f"{rng.uniform(.3, .7):.4f} {rng.uniform(.1, .4):.4f}"
                        f" {rng.uniform(.1, .4):.4f}\n")
    return str(imd), str(lbd), root


def test_cli_one_epoch_with_autoanchor_evolve_and_hyp(tree, capsys):
    imd, lbd, root = tree
    ck, runs = str(root / "ck"), str(root / "runs")
    state = train_yolo.main([
        "--img-dir", imd, "--label-dir", lbd, "--nc", "3",
        "--arch", "yolov5n", "--imgsz", "64", "--batch-size", "4",
        "--epochs", "1", "--ckpt-dir", ck, "--runs-dir", runs,
        "--autoanchor", "--evolve", "1", "--hyp", "obj=1.5",
        "--workers", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "evolved anchors" in out and "epoch 0:" in out
    assert state["step"] == 2
    for name in ("last.npz", "best.npz"):
        got, _ = load_state(os.path.join(ck, name))
        assert got.keys() == state["ema"].keys()
    with open(os.path.join(ck, "hyp_evolve.yaml")) as f:
        text = f.read()
    doc = yaml.safe_load(text)
    assert text == yaml.safe_dump(doc)          # what safe_dump writes
    assert doc["hyp"]["obj"] == 1.5 and set(doc["hyp"]) == set(
        train_yolo.DEFAULT_HYP)
    with open(os.path.join(ck, "evolve.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0][:2] == ["gen", "fitness"] and len(rows) == 2
    with open(os.path.join(ck, "results.csv")) as f:
        assert f.readline().strip() == "step,map50,map,fitness"
    manifests = [d for d in os.listdir(os.path.join(runs, "yolo"))]
    assert len(manifests) == 1


def test_hyp_yaml_equals_safe_dump():
    hyp = {"lr0": 0.01, "b_tiny": 1e-17, "big": 1e17, "neg": -2.5,
           "zero": 0.0, "third": 1 / 3}
    for fit in (0.0, 0.12345678901234, float("nan"), float("inf")):
        text = train_yolo.hyp_yaml(fit, hyp)
        assert text == yaml.safe_dump({"fitness": fit, "hyp": hyp})


@pytest.mark.parametrize("world", [None, "1"])
def test_data_parallel_needs_the_env(tree, monkeypatch, world):
    """--data-parallel without WORLD_SIZE above 1 raises, naming the env
    contract, before any run is opened."""
    imd, lbd, root = tree
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit, match="one process a card"):
        train_yolo.main([
            "--img-dir", imd, "--label-dir", lbd, "--nc", "3",
            "--arch", "yolov5n", "--imgsz", "64", "--batch-size", "4",
            "--epochs", "1", "--workers", "0",
            "--ckpt-dir", str(root / "dp"),
            "--runs-dir", str(root / "dp_runs"), "--device", "cpu",
            "--data-parallel"])
    assert not os.path.exists(root / "dp_runs")


def test_evolve_mutation_and_csv_match_jax(tmp_path):
    base = dict(train_yolo.DEFAULT_HYP)
    for seed in range(3):
        a = jev.mutate(base, random.Random(seed))
        b = tev.mutate(base, random.Random(seed))
        assert a == b
    assert tev.META == jev.META

    def fit_of(h):
        return -abs(h["lr0"] - 0.02) - abs(h["obj"] - 1.2)

    paths = [str(tmp_path / "j.csv"), str(tmp_path / "t.csv")]
    rj = jev.evolve(base, fit_of, generations=4, seed=5, log_path=paths[0])
    rt = tev.evolve(base, fit_of, generations=4, seed=5, log_path=paths[1])
    assert rj == rt
    with open(paths[0]) as f, open(paths[1]) as g:
        assert f.read() == g.read()
    tev.evolve(base, fit_of, generations=1, seed=5, log_path=paths[1])
    assert os.path.exists(paths[1] + ".prev")          # rotated, not mixed


def test_kmeans_and_check_anchors_match_jax():
    rng = np.random.RandomState(0)
    wh = np.concatenate([rng.uniform(5, 40, (60, 2)),
                         rng.uniform(60, 200, (40, 2))]).astype(np.float32)
    np.testing.assert_array_equal(taa.kmeans_anchors(wh, n=9, gen=200),
                                  jaa.kmeans_anchors(wh, n=9, gen=200))
    np.testing.assert_array_equal(taa.kmeans_anchors(wh[:5], n=9, gen=50),
                                  jaa.kmeans_anchors(wh[:5], n=9, gen=50))
    assert taa.anchor_metric(wh, wh[:9]) == jaa.anchor_metric(wh, wh[:9])
    bad = np.full((3, 3, 2), 500.0, np.float32)
    a, ev = taa.check_anchors(wh, bad)
    b, ev_j = jaa.check_anchors(wh, bad)
    assert ev and ev == ev_j
    np.testing.assert_array_equal(a, b)


def test_step_guard_and_resume_match_jax(tmp_path):
    for g in (tg.StepGuard(max_consecutive=3), jg.StepGuard(max_consecutive=3)):
        assert g.check(1.0) and not g.check(float("nan"))
        assert not g.check(float("inf")) and g.check(2.0)
        g.check(float("nan"))
        g.check(float("nan"))
        with pytest.raises(FloatingPointError):
            g.check(float("nan"))
        assert g.total_skipped == 5
    (tmp_path / "a").mkdir()
    for i, name in enumerate(("a/x.npz", "y.npz")):
        p = tmp_path / name
        p.write_bytes(b"0")
        os.utime(p, (1000 + i, 1000 + i))
    assert (tg.auto_resume_latest(str(tmp_path))
            == jg.auto_resume_latest(str(tmp_path))
            == str(tmp_path / "y.npz"))
    assert tg.auto_resume_latest(str(tmp_path / "none")) is None
    import torch

    assert bool(tg.all_finite([torch.ones(3), None, torch.arange(3)]))
    assert not bool(tg.all_finite([torch.ones(3), torch.tensor([np.inf])]))


def test_loggers_and_callbacks(tmp_path):
    from lpr_tpu.utils import callbacks as jcb
    from lpr_tpu.utils import loggers as jlog

    assert HOOKS == jcb.HOOKS
    for mod, name in ((jlog, "j"), (None, "t")):
        lg = (mod.Loggers if mod else Loggers)(str(tmp_path / name))
        lg.log({"map": 0.25, "loss": 3}, 0)
        lg.log({"map": 0.5, "loss": 2, "extra": 1}, 1)
    with open(tmp_path / "j" / "results.csv") as f, \
            open(tmp_path / "t" / "results.csv") as g:
        assert f.read() == g.read()
    log = Loggers(str(tmp_path / "run"))
    assert log.tb is None
    log.log({"map": 0.5, "loss": np.float32(2.0)}, 0)
    log.log({"map": 0.6, "loss": 1.5}, 1)
    with open(tmp_path / "run" / "results.csv") as f:
        assert f.read().splitlines() == ["step,map,loss", "0,0.5,2.0",
                                         "1,0.6,1.5"]
    c = CsvLogger(str(tmp_path / "x" / "r.csv"))
    c.log({"a": 1}, 3)
    assert (tmp_path / "x" / "r.csv").exists()
    cb, seen = Callbacks(), []
    cb.register_action("on_train_start", "a", lambda: seen.append(1))
    cb.run("on_train_start")
    assert seen == [1] and "teardown" in HOOKS
    with pytest.raises(ValueError):
        cb.register_action("nope", "a", lambda: None)
    with pytest.raises(ValueError):
        cb.run("nope")


def test_bench_input_and_synth_labels(tmp_path, capsys):
    """``bench_input``'s JSON line on a two-frame tree at 64x64 on the CPU,
    and ``synth_frames``' labels: the same frames with or without them,
    classes 7/8 by the panel's rows, boxes inside the frame."""
    import json

    from lpr_tpu_torch.tools import bench_input
    from lpr_tpu_torch.tools.synth import synth_frames, write_yolo_tree

    assert bench_input.main(["--n", "2", "--batch", "2", "--imgsz", "64",
                             "--workers", "2", "--epochs", "1",
                             "--root", str(tmp_path / "tree")]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["format"] == "png" and rec["frames"] == 2
    for k in ("cold_imgs_per_s", "cached_imgs_per_s", "workers_imgs_per_s"):
        assert rec[k] > 0, k
    frames, boxes = synth_frames(3, (72, 128), 5, labels=True)
    np.testing.assert_array_equal(frames, synth_frames(3, (72, 128), 5))
    for b in boxes:
        assert len(b) >= 1 and set(b[:, 0]) <= {7.0, 8.0}
        assert (b[:, 1:] > 0).all() and (b[:, 1:] <= 1).all()
        assert ((b[:, 1:3] - b[:, 3:5] / 2) >= 0).all()
        assert ((b[:, 1:3] + b[:, 3:5] / 2) <= 1 + 1e-6).all()
    img_dir, lbl_dir = write_yolo_tree(str(tmp_path / "t2"), 1, (72, 128), 5)
    with open(os.path.join(lbl_dir, "f00000.txt")) as f:
        assert len(f.read().splitlines()) >= 1
