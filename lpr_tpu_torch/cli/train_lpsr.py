"""LPSR training CLI (counterpart of ``lpr_tpu/cli/train_lpsr.py``,
reference ``train/lpsr.py:204-218``).

    python -m lpr_tpu_torch.cli.train_lpsr --hr-train-dir hr/ \\
        --lr-train-dir lr/ --hr-val-dir hr_val/ --lr-val-dir lr_val/ \\
        [--resume ckpt.npz | --resume-run] [--device cpu]

Each run is recorded in the run registry (:mod:`lpr_tpu_torch.utils
.registry`, the JAX package's layout): its config, the dataset
fingerprint, ``last_model.npz`` as ``latest`` and ``best_model.npz`` as
``best``.  ``--resume-run`` warm-starts from the newest run's ``latest``
checkpoint and records that run as the parent.

Data parallelism: one process a device, started with the env contract of
:mod:`lpr_tpu_torch.parallel.multiproc` (``COORDINATOR_ADDRESS``,
``WORLD_SIZE``, ``RANK``).  ``--batch-size`` is then the global batch;
each rank trains and validates a strided, equal-length subset of the
pairs (``[:n][r::w]``), the gradients are averaged over the ranks each
step, and the validation PSNRs are gathered, so every rank takes the same
plateau decision.  Rank 0 alone writes checkpoints and the registry;
``--resume-run`` is resolved on every rank.  ``--data-parallel`` without
that env (``WORLD_SIZE`` above 1) raises: one process drives one card.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train LPSR")
    p.add_argument("--hr-train-dir", required=True)
    p.add_argument("--lr-train-dir", required=True)
    p.add_argument("--hr-val-dir", required=True)
    p.add_argument("--lr-val-dir", required=True)
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--ckpt-dir", default="checkpoints/lpsr")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint .npz to warm-start from")
    p.add_argument("--resume-run", action="store_true",
                   help="warm-start from the newest registry run's 'latest' "
                        "checkpoint and record it as this run's parent")
    p.add_argument("--runs-dir", default="runs",
                   help="run-artifact registry root")
    p.add_argument("--run-project", default="lpsr")
    p.add_argument("--data-parallel", action="store_true",
                   help="data parallelism: needs the env "
                        "COORDINATOR_ADDRESS/WORLD_SIZE/RANK with "
                        "WORLD_SIZE above 1 (one process a card), which "
                        "alone also turns it on")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from lpr_tpu_torch.data.datasets import PairedImageDataset
    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.models.lpsr import LPSRConfig
    from lpr_tpu_torch.parallel.mesh import make_mesh
    from lpr_tpu_torch.parallel.multiproc import (DATA_PARALLEL_NEEDS_ENV,
                                                  initialize_from_env,
                                                  is_main_process,
                                                  rank_share)
    from lpr_tpu_torch.train.lpsr import LPSRTrainConfig, LPSRTrainer
    from lpr_tpu_torch.utils.registry import RunRegistry
    from lpr_tpu_torch.weights.checkpoint import load_state

    if args.data_parallel and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        raise SystemExit(DATA_PARALLEL_NEEDS_ENV)
    dev = resolve_device(args.device)
    dist = initialize_from_env(dev)
    if dist and dev.type == "cuda":
        import torch

        dev = torch.device("cuda", torch.cuda.current_device())
    hw = (args.height, args.width)
    train_ds = PairedImageDataset(args.hr_train_dir, args.lr_train_dir, hw)
    val_ds = PairedImageDataset(args.hr_val_dir, args.lr_val_dir, hw)

    batch_size = args.batch_size
    if dist:     # --batch-size is the global batch
        for ds in (train_ds, val_ds):
            ds.pairs, batch_size = rank_share(ds.pairs, args.batch_size)
    mesh = make_mesh(devices=[dev]) if dist else None
    main_proc = is_main_process()
    log = ((lambda m: print(m, flush=True)) if main_proc
           else (lambda m: None))
    log(f"train {len(train_ds)} pairs, val {len(val_ds)} pairs"
        + (" a rank" if dist else ""))

    trainer = LPSRTrainer(LPSRTrainConfig(lr=args.lr), LPSRConfig(),
                          device=dev, mesh=mesh)
    os.makedirs(args.ckpt_dir, exist_ok=True)

    # run-artifact registry: config + dataset fingerprint + ckpt lineage
    run = parent = None
    resume_path = args.resume
    data_dirs = [args.hr_train_dir, args.lr_train_dir,
                 args.hr_val_dir, args.lr_val_dir]
    registry = RunRegistry(args.runs_dir)
    if args.resume_run:
        # resolved on every rank (read only): every rank must warm-start
        # from the same weights, and a missing run must stop every rank;
        # the newest run with a 'latest' checkpoint, so a rank that comes
        # after rank 0 has opened the new run resolves the same parent
        parent = registry.latest(args.run_project, with_artifact="latest")
        if parent is None:
            raise SystemExit(f"--resume-run: no prior runs under "
                             f"{args.runs_dir}/{args.run_project}")
        if resume_path is None:
            resume_path = registry.resume_checkpoint(args.run_project)
    if main_proc:
        # the registry is written by rank 0 alone (run ids are allocated
        # by the directory's contents)
        run = registry.new_run(args.run_project, config=vars(args),
                               dataset_dirs=data_dirs, resume_from=parent)
        log(f"run {run.id} (dataset {run.manifest['dataset_fingerprint']})")

    init_params = None
    if resume_path:
        init_params = load_state(resume_path)[0]
        log(f"resumed weights from {resume_path}")

    epoch_counter = [0]

    def train_batches():
        epoch_counter[0] += 1
        return train_ds.batches(batch_size, shuffle=True,
                                seed=epoch_counter[0], drop_last=True)

    def val_batches():
        return val_ds.batches(batch_size, shuffle=False, drop_last=True)

    state = trainer.fit(train_batches, val_batches, args.epochs,
                        ckpt_dir=args.ckpt_dir if main_proc else None,
                        init_params=init_params, logger=log)
    best_psnr = float(state["best_psnr"])
    if run is not None:
        for fname, aliases in (("last_model.npz", ("latest",)),
                               ("best_model.npz", ("best",))):
            p = os.path.join(args.ckpt_dir, fname)
            if os.path.exists(p):
                run.log_artifact(p, aliases=aliases,
                                 metrics={"best_psnr": best_psnr})
        run.finish({"best_psnr": best_psnr, "epochs": args.epochs})
    log(f"done; best PSNR {state['best_psnr']}")
    if dist:
        # every rank returns once rank 0 has recorded the run, so that a
        # next run's --resume-run finds it on every rank
        import torch.distributed as tdist

        tdist.barrier()
    return state


if __name__ == "__main__":
    main()
