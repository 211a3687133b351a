"""One rank of ``tests/test_torch_parallel.py``'s process group: run as
``python tests/torch_parallel_worker.py ROOT [PART ...]`` (``lpsr``,
``yolo``, ``cli``; default all) with the env contract of
``lpr_tpu_torch.parallel.multiproc`` set (gloo on the CPU, a ``file://``
store).  Reads ``ROOT/inputs.npz`` and the trees under ``ROOT`` that the
test wrote, and writes ``ROOT/rank<r>.npz``: the LPSR and detector
trainers' steps on this rank's share of each global batch, and the
training CLIs run on the group.  Imports the port only."""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lpr_tpu_torch.parallel import collectives, multiproc  # noqa: E402
from lpr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

# micro-batch j of a step is the union of every rank's micro-batch j
ACC = 2


def local_rows(n_global: int, rank: int, world: int, acc: int = 1):
    """This rank's rows of a global batch so that the global micro-batch
    j (rows j*n/acc to (j+1)*n/acc) is the union of the ranks' local
    micro-batch j, each rank's local batch in micro-batch order."""
    m = n_global // (acc * world)
    return np.concatenate([np.arange(j * world * m + rank * m,
                                     j * world * m + (rank + 1) * m)
                           for j in range(acc)])


def lpsr_part(inp, out, rank, world):
    from lpr_tpu_torch.models.lpsr import LPSRConfig
    from lpr_tpu_torch.train.lpsr import LPSRTrainConfig, LPSRTrainer

    cfg = LPSRConfig(num_features=8, growth_rate=4, num_blocks=2,
                     num_layers=2)
    tr = LPSRTrainer(LPSRTrainConfig(), cfg, mesh=make_mesh())
    flat = {k[5:]: v for k, v in inp.items() if k.startswith("lpsr/")}
    st = tr.init(params=flat)
    for s in range(2):
        rows = local_rows(len(inp[f"lpsr_lr{s}"]), rank, world)
        st, loss = tr.step(st, inp[f"lpsr_lr{s}"][rows],
                           inp[f"lpsr_hr{s}"][rows])
        out[f"lpsr_loss{s}"] = float(loss)
    rows = local_rows(len(inp["lpsr_val_lr"]), rank, world)
    out["lpsr_psnr"] = tr.validate(
        st, [(inp["lpsr_val_lr"][rows], inp["lpsr_val_hr"][rows])])
    for k, v in st["params"].items():
        out[f"lpsr_p/{k}"] = v.detach().numpy()


def yolo_part(inp, out, rank, world):
    from lpr_tpu_torch.models.yolo import build_yolo, yolov5_spec
    from lpr_tpu_torch.train.yolo import YoloTrainConfig, YoloTrainer

    model = build_yolo(yolov5_spec(nc=3, depth=0.33, width=0.25),
                       strides=(8, 16, 32))
    tr = YoloTrainer(model, YoloTrainConfig(), steps_per_epoch=10,
                     accumulate=ACC, mesh=make_mesh())
    flat = {k[5:]: v for k, v in inp.items() if k.startswith("yolo/")}
    st = tr.init(params=flat)
    st["step"] = int(inp["yolo_step0"])
    for s in range(2):
        x, lab = inp[f"yolo_x{s}"], inp[f"yolo_lab{s}"]
        rows = local_rows(len(x), rank, world, ACC)
        x, lab = torch.from_numpy(x[rows]), torch.from_numpy(lab[rows])
        if s == 0:
            g, _, _, _ = tr.grads(st["params"], x, lab)
            for k, v in zip(g, collectives.average(list(g.values()),
                                                   tr.group)):
                out[f"yolo_g/{k}"] = v.numpy()
        st, total, comps = tr.step(st, x, lab)
        out[f"yolo_loss{s}"] = float(total)
        for k, v in comps.items():
            out[f"yolo_comp{s}/{k}"] = float(v)
        if s == 0:
            for part in ("params", "momenta", "ema"):
                for k, v in st[part].items():
                    out[f"yolo_{part}/{k}"] = v.detach().numpy().copy()
    for k, v in st["params"].items():
        out[f"yolo_p2/{k}"] = v.detach().numpy()


def cli_part(root, out):
    from lpr_tpu_torch.cli import train_lpsr, train_yolo

    with open(os.path.join(root, "cli_args.txt")) as f:
        lpsr_args, yolo_args = [line.split() for line in f.read()
                                .splitlines()]
    d = os.path.join(root, "multi")
    a = lpsr_args + ["--ckpt-dir", f"{d}/lpsr_ck", "--runs-dir",
                     f"{d}/runs"]
    train_lpsr.main(a)
    st = train_lpsr.main(a + ["--resume-run"])
    for k, v in st["params"].items():
        out[f"cli_lpsr/{k}"] = v.detach().numpy()
    st = train_yolo.main(yolo_args + ["--ckpt-dir", f"{d}/yolo_ck",
                                      "--runs-dir", f"{d}/runs"])
    for k, v in st["ema"].items():
        out[f"cli_yolo/{k}"] = v.detach().numpy()
    st = train_yolo.main(yolo_args + [
        "--ckpt-dir", f"{d}/evolve_ck", "--runs-dir", f"{d}/runs",
        "--evolve", "1", "--epochs", "1"])
    for k, v in st["ema"].items():
        out[f"cli_evolve/{k}"] = v.detach().numpy()


def main(root: str, parts) -> None:
    torch.set_num_threads(1)
    if not multiproc.initialize_from_env("cpu"):
        raise SystemExit("WORLD_SIZE must be above 1")
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    inp = dict(np.load(os.path.join(root, "inputs.npz")))
    out = {"main": float(multiproc.is_main_process()),
           "slice": np.asarray([multiproc.local_slice(8).start,
                                multiproc.local_slice(8).stop])}
    for part in parts:
        if part == "cli":
            cli_part(root, out)
        else:
            {"lpsr": lpsr_part, "yolo": yolo_part}[part](inp, out, rank,
                                                          world)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or ["lpsr", "yolo", "cli"])
