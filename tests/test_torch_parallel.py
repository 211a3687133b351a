"""The port's data parallelism against one process and against the JAX
package's mesh, on the CPU.

Two ranks over gloo (a ``file://`` store in the test's temporary
directory; ``tests/torch_parallel_worker.py``, spawned once for the
module) run, each on N images of a global batch of 2N:

- the LPSR trainer (JAX's tiny configuration) for two steps and
  ``validate``;
- the detector trainer (yolov5, depth 0.33, width 0.25, nc 3, 64x64,
  ``accumulate=2``, past warm-up) for two steps, with the global batch
  statistics and positive count;
- ``cli/train_lpsr`` (a run and a ``--resume-run``), ``cli/train_yolo``
  and ``cli/train_yolo --evolve 1`` at ``WORLD_SIZE=2``.

Each is held to the port's one process on the 2N images (the trainers
without a mesh, the CLIs without the env), and the LPSR trainer to JAX's
trainer with ``mesh=make_mesh(2)`` on the 2N images (the detector's JAX
mesh step: ``tests/test_torch_parallel_det.py``; the recognizer's:
``tests/test_torch_parallel_recognizer.py``).  Bounds
(``tests/test_multiproc.py``'s): the losses within 2e-6 relative; the
weights within 1e-5, each after the LPSR's steps and the detector's
first, and the detector's after two steps as test_multiproc holds them,
their sum within 1e-5 relative (a second step on weights that differ by
rounding moves the detector's stem by up to ~2e-5 through the batch
statistics of 2x2 maps)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lpr_tpu.models import lpsr as jlpsr
from lpr_tpu.models import yolo as jy
from lpr_tpu.parallel import mesh as jmesh
from lpr_tpu.parallel import multiproc as jmp
from lpr_tpu.train import lpsr as jlt
from lpr_tpu_torch.models import lpsr as tlpsr
from lpr_tpu_torch.models import yolo as ty
from lpr_tpu_torch.models.yolo_train import yolo_init
from lpr_tpu_torch.parallel import mesh as tmesh
from lpr_tpu_torch.parallel import multiproc as tmp
from lpr_tpu_torch.train import lpsr as tlt
from lpr_tpu_torch.train import yolo as tyt
from lpr_tpu_torch.weights.checkpoint import load_state, params_from_jax

from .test_torch_yolo_train import _labels, _t_spec
from .train_ref import jax_tree, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
N = 4                     # images a rank
TINY_J = jlpsr.LPSRConfig(num_features=8, growth_rate=4, num_blocks=2,
                          num_layers=2)
TINY_T = tlpsr.LPSRConfig(num_features=8, growth_rate=4, num_blocks=2,
                          num_layers=2)
YOLO_HW = (64, 64)
ACC = 2
STEP0 = 1000
LOSS_RTOL = 2e-6
PARAM_TOL = 1e-5


def _yolo_spec():
    return jy.yolov5_spec(nc=3, depth=0.33, width=0.25)


def _inputs():
    rng = np.random.RandomState(0)
    inp = {}
    for k, v in tlpsr.lpsr_init(torch.Generator().manual_seed(0),
                                TINY_T).items():
        inp[f"lpsr/{k}"] = v
    for s in range(2):
        inp[f"lpsr_lr{s}"] = rng.rand(2 * N, 16, 32, 3).astype(np.float32)
        inp[f"lpsr_hr{s}"] = rng.rand(2 * N, 16, 32, 1).astype(np.float32)
    inp["lpsr_val_lr"] = rng.rand(2 * N, 16, 32, 3).astype(np.float32)
    inp["lpsr_val_hr"] = rng.rand(2 * N, 16, 32, 1).astype(np.float32)
    tm = ty.build_yolo(_t_spec(_yolo_spec()), strides=(8, 16, 32))
    for k, v in yolo_init(tm, torch.Generator().manual_seed(1)).items():
        inp[f"yolo/{k}"] = v
    for s in range(2):
        inp[f"yolo_x{s}"] = rng.rand(2 * N, *YOLO_HW, 3).astype(np.float32)
        inp[f"yolo_lab{s}"] = _labels(2 * N)
    inp["yolo_step0"] = np.asarray(STEP0)
    return inp


def _trees(root):
    from lpr_tpu_torch.imageio import write_png

    rng = np.random.RandomState(1)
    for split in ("tr", "va"):
        for kind in ("hr", "lr"):
            d = os.path.join(root, "lpsr_tree", split, kind)
            os.makedirs(d)
            for i in range(4):
                write_png(os.path.join(d, f"p{i}.png"),
                          rng.randint(0, 255, (16, 32, 3), np.uint8))
    imd = os.path.join(root, "det", "images")
    lbd = os.path.join(root, "det", "labels")
    os.makedirs(imd)
    os.makedirs(lbd)
    for i in range(4):
        write_png(os.path.join(imd, f"im{i}.png"),
                  (rng.rand(80, 96, 3) * 255).astype(np.uint8))
        with open(os.path.join(lbd, f"im{i}.txt"), "w") as f:
            for _ in range(3):
                f.write(f"{rng.randint(0, 3)} {rng.uniform(.3, .7):.4f} "
                        f"{rng.uniform(.3, .7):.4f} {rng.uniform(.1, .4):.4f}"
                        f" {rng.uniform(.1, .4):.4f}\n")
    t = os.path.join(root, "lpsr_tree")
    lpsr_args = ["--hr-train-dir", f"{t}/tr/hr", "--lr-train-dir",
                 f"{t}/tr/lr", "--hr-val-dir", f"{t}/va/hr", "--lr-val-dir",
                 f"{t}/va/lr", "--width", "32", "--height", "16",
                 "--batch-size", "4", "--epochs", "1", "--device", "cpu"]
    yolo_args = ["--img-dir", imd, "--label-dir", lbd, "--nc", "3",
                 "--arch", "yolov5n", "--imgsz", "64", "--batch-size", "4",
                 "--epochs", "2", "--no-augment", "--workers", "0",
                 "--device", "cpu"]
    with open(os.path.join(root, "cli_args.txt"), "w") as f:
        f.write(" ".join(lpsr_args) + "\n" + " ".join(yolo_args) + "\n")
    return lpsr_args, yolo_args


def _single(inp, root, lpsr_args, yolo_args):
    """The port in this process on the global batches: the trainers
    without a mesh, the CLIs without the env."""
    from lpr_tpu_torch.cli import train_lpsr, train_yolo

    out = {}
    tr = tlt.LPSRTrainer(tlt.LPSRTrainConfig(), TINY_T, device="cpu")
    st = tr.init(params={k[5:]: v for k, v in inp.items()
                         if k.startswith("lpsr/")})
    for s in range(2):
        st, loss = tr.step(st, inp[f"lpsr_lr{s}"], inp[f"lpsr_hr{s}"])
        out[f"lpsr_loss{s}"] = float(loss)
    out["lpsr_psnr"] = tr.validate(st, [(inp["lpsr_val_lr"],
                                         inp["lpsr_val_hr"])])
    out["lpsr_p"] = {k: v.detach().numpy() for k, v in st["params"].items()}

    tm = ty.build_yolo(_t_spec(_yolo_spec()), strides=(8, 16, 32))
    ytr = tyt.YoloTrainer(tm, tyt.YoloTrainConfig(), steps_per_epoch=10,
                          accumulate=ACC, device="cpu")
    yst = ytr.init(params={k[5:]: v for k, v in inp.items()
                           if k.startswith("yolo/")})
    yst["step"] = STEP0
    for s in range(2):
        yst, total, _ = ytr.step(yst, inp[f"yolo_x{s}"], inp[f"yolo_lab{s}"])
        out[f"yolo_loss{s}"] = float(total)
        if s == 0:
            out["yolo_p1"] = {k: v.detach().numpy().copy()
                              for k, v in yst["params"].items()}
    out["yolo_p2"] = {k: v.detach().numpy()
                      for k, v in yst["params"].items()}

    d = os.path.join(root, "single")
    a = lpsr_args + ["--ckpt-dir", f"{d}/lpsr_ck", "--runs-dir", f"{d}/runs"]
    train_lpsr.main(a)
    st = train_lpsr.main(a + ["--resume-run"])
    out["cli_lpsr"] = {k: v.detach().numpy() for k, v in st["params"].items()}
    st = train_yolo.main(yolo_args + ["--ckpt-dir", f"{d}/yolo_ck",
                                      "--runs-dir", f"{d}/runs"])
    out["cli_yolo"] = {k: v.detach().numpy() for k, v in st["ema"].items()}
    return out


def _sub(npz, prefix):
    return {k[len(prefix):]: npz[k] for k in npz if k.startswith(prefix)}


def spawn_ranks(root, parts):
    """The two ranks of ``tests/torch_parallel_worker.py`` on ``parts``,
    started at once over a ``file://`` store in ``root``."""
    env = dict(os.environ, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1",
               COORDINATOR_ADDRESS="file://" + os.path.join(root, "store"),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_parallel_worker.py"), root,
         *parts], env=dict(env, RANK=str(r)), cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]


def join_ranks(procs, root):
    """Wait for the ranks (each killed if the test fails first) and load
    their results."""
    try:
        errs = []
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(f"rank {r} rc {p.returncode}:\n{err[-3000:]}")
        assert not errs, "\n".join(errs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(os.path.join(root, f"rank{r}.npz")))
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two ranks started at once, the one-process references computed
    meanwhile; (inputs, single, [rank 0's, rank 1's results], root)."""
    root = str(tmp_path_factory.mktemp("dp"))
    inp = _inputs()
    np.savez(os.path.join(root, "inputs.npz"), **inp)
    lpsr_args, yolo_args = _trees(root)
    procs = spawn_ranks(root, ["lpsr", "yolo", "cli"])
    try:
        single = _single(inp, root, lpsr_args, yolo_args)
    finally:
        got = join_ranks(procs, root)
    return inp, single, got, root


def fingerprint(state) -> float:
    return sum(float(np.float64(v).sum()) for v in state.values())


def _close(a, b, tol, what):
    assert a.keys() == b.keys(), what
    for k in a:
        err = np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()
        assert err <= tol, (what, k, err)


def test_ranks_share_the_work_and_gate_on_rank_0(ranks):
    _, _, got, _ = ranks
    assert [float(g["main"]) for g in got] == [1.0, 0.0]
    assert [list(g["slice"]) for g in got] == [[0, 4], [4, 8]]


def test_lpsr_two_ranks_equal_one_process_and_jax_mesh(ranks):
    inp, single, got, _ = ranks
    for g in got:
        for s in range(2):
            assert abs(g[f"lpsr_loss{s}"] - single[f"lpsr_loss{s}"]) <= \
                LOSS_RTOL * abs(single[f"lpsr_loss{s}"])
        _close(_sub(g, "lpsr_p/"), single["lpsr_p"], PARAM_TOL, "weights")
        assert abs(float(g["lpsr_psnr"]) - single["lpsr_psnr"]) <= 1e-4
    # every rank took the same plateau input and the same weights
    assert float(got[0]["lpsr_psnr"]) == float(got[1]["lpsr_psnr"])
    _close(_sub(got[0], "lpsr_p/"), _sub(got[1], "lpsr_p/"), 0.0, "ranks")

    flat = {k[5:]: v for k, v in inp.items() if k.startswith("lpsr/")}
    jt = jlt.LPSRTrainer(jlt.LPSRTrainConfig(), TINY_J,
                         mesh=jmesh.make_mesh(2))
    js = jt.init(params=jax_tree(jlpsr.lpsr_init, flat, TINY_J))
    for s in range(2):
        js, loss = jt.step(js, inp[f"lpsr_lr{s}"], inp[f"lpsr_hr{s}"])
        assert abs(float(got[0][f"lpsr_loss{s}"]) - float(loss)) <= \
            LOSS_RTOL * abs(float(loss))
    jp = params_from_jax(jax.device_get(js["params"]))
    _close(_sub(got[0], "lpsr_p/"), jp, PARAM_TOL, "weights against JAX")


def test_yolo_two_ranks_equal_one_process(ranks):
    """Global batch statistics and positive count: 2 ranks x 4 images
    with accumulate=2 equal one process on the 8 (JAX's mesh step:
    ``tests/test_torch_parallel_det.py``)."""
    _, single, got, _ = ranks
    for g in got:
        for s in range(2):
            assert abs(g[f"yolo_loss{s}"] - single[f"yolo_loss{s}"]) <= \
                LOSS_RTOL * abs(single[f"yolo_loss{s}"]), s
        _close(_sub(g, "yolo_params/"), single["yolo_p1"], PARAM_TOL,
               "one step")
        fp = fingerprint(single["yolo_p2"])
        assert abs(fingerprint(_sub(g, "yolo_p2/")) - fp) <= \
            PARAM_TOL * max(1.0, abs(fp))
    _close(_sub(got[0], "yolo_p2/"), _sub(got[1], "yolo_p2/"), 0.0, "ranks")


def test_training_clis_at_world_size_2_equal_one_process(ranks):
    """Rank 0 alone writes the registry and checkpoints; --resume-run is
    resolved on both ranks (equal warm starts); the weights equal one
    process's on the same global batch; under --evolve both ranks keep
    in step and evolve.csv has one generation's row."""
    from lpr_tpu_torch.utils.registry import RunRegistry

    _, single, got, root = ranks
    reg = RunRegistry(os.path.join(root, "multi", "runs"))
    runs = sorted(os.listdir(os.path.join(root, "multi", "runs", "lpsr")))
    assert runs == ["run-0000", "run-0001"]
    assert reg.latest("lpsr").manifest["parent"]["run_id"] == \
        "lpsr/run-0000"
    assert len(os.listdir(os.path.join(root, "multi", "runs", "yolo"))) == 2
    for name in ("cli_lpsr/", "cli_yolo/", "cli_evolve/"):
        _close(_sub(got[0], name), _sub(got[1], name), 0.0, name)
    _close(_sub(got[0], "cli_lpsr/"), single["cli_lpsr"], PARAM_TOL,
           "train_lpsr")
    fp = fingerprint(single["cli_yolo"])     # two steps, as above
    assert abs(fingerprint(_sub(got[0], "cli_yolo/")) - fp) <= \
        PARAM_TOL * max(1.0, abs(fp))
    last, _ = load_state(os.path.join(root, "multi", "yolo_ck", "last.npz"))
    _close(last, _sub(got[0], "cli_yolo/"), 0.0, "last.npz")
    with open(os.path.join(root, "multi", "evolve_ck", "evolve.csv")) as f:
        assert len(f.read().strip().splitlines()) == 2
    assert os.path.exists(os.path.join(root, "multi", "evolve_ck",
                                       "hyp_evolve.yaml"))


def test_multiproc_dp_check():
    single, multi = tmp.multiproc_dp_check(n_processes=2,
                                           per_process_batch=4, timeout=240)
    assert multi["n_processes"] == 2 and single["n_processes"] == 1
    np.testing.assert_allclose(multi["losses"], single["losses"], rtol=2e-6)


def test_mesh_helpers_match_jax(monkeypatch):
    rng = np.random.RandomState(0)
    for b, mult in ((5, 4), (8, 4), (1, 3), (7, 2)):
        x = rng.rand(b, 3, 2).astype(np.float32)
        jp, jn = jmesh.pad_to_multiple(x, mult)
        tp, tn = tmesh.pad_to_multiple(x, mult)
        np.testing.assert_array_equal(tp, jp)
        assert tn == jn
        tt, tn2 = tmesh.pad_to_multiple(torch.from_numpy(x), mult)
        np.testing.assert_array_equal(tt.numpy(), jp)
        assert tn2 == jn
    for n in (8, 7, 1):
        assert tmp.local_slice(n) == jmp.local_slice(n)
    assert tmp.is_main_process() == jmp.is_main_process()
    assert tmp.rank_share(list(range(5)), 4) == (list(range(5)), 4)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmp.initialize_from_env("cpu") is jmp.initialize_from_env()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmp.initialize_from_env("cpu") is jmp.initialize_from_env()
    # a card that is not there raises; nothing falls back to gloo
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmp.initialize_from_env("cuda")


def test_make_mesh_shard_and_replicate():
    mesh = tmesh.make_mesh(2)
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.group is None
    assert tmesh.make_mesh().size == 1
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    parts = tmesh.shard_batch({"x": x, "n": None}, mesh)
    np.testing.assert_array_equal(parts[0]["x"].numpy(), x[:3])
    np.testing.assert_array_equal(parts[1]["x"].numpy(), x[3:])
    assert parts[1]["n"] is None
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.shard_batch(x[:5], mesh)
    w = torch.ones(3)
    reps = tmesh.replicate([w], mesh)
    assert all(torch.equal(r[0], w) for r in reps)
    assert reps[0][0].data_ptr() != reps[1][0].data_ptr() != w.data_ptr()


@pytest.mark.parametrize("which", ["lpsr", "yolo"])
def test_a_trainer_mesh_holds_one_local_device(which):
    """One process drives one device: a trainer given a mesh of two
    local devices raises."""
    mesh = tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="one device a process"):
        if which == "lpsr":
            tlt.LPSRTrainer(tlt.LPSRTrainConfig(), TINY_T, mesh=mesh)
        else:
            tyt.YoloTrainer(ty.build_yolo(_t_spec(_yolo_spec()),
                                          strides=(8, 16, 32)), mesh=mesh)
