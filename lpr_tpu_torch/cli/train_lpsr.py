"""LPSR training CLI (counterpart of ``lpr_tpu/cli/train_lpsr.py``,
reference ``train/lpsr.py:204-218``).

    python -m lpr_tpu_torch.cli.train_lpsr --hr-train-dir hr/ \\
        --lr-train-dir lr/ --hr-val-dir hr_val/ --lr-val-dir lr_val/ \\
        [--resume ckpt.npz | --resume-run] [--device cpu]

Each run is recorded in the run registry (:mod:`lpr_tpu_torch.utils
.registry`, the JAX package's layout): its config, the dataset
fingerprint, ``last_model.npz`` as ``latest`` and ``best_model.npz`` as
``best``.  ``--resume-run`` warm-starts from the newest run's ``latest``
checkpoint and records that run as the parent.  Data parallelism
(``--data-parallel``, or ``WORLD_SIZE`` above 1) is not ported yet and
raises.
"""

from __future__ import annotations

import argparse
import os

NOT_PORTED = ("data-parallel LPSR training is not ported yet: it comes "
              "with the port of lpr_tpu/parallel (ROADMAP section 1, item "
              "7); run on one card")


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
                   help="not ported yet (raises)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit(NOT_PORTED)
    from lpr_tpu_torch.data.datasets import PairedImageDataset
    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.models.lpsr import LPSRConfig
    from lpr_tpu_torch.train.lpsr import LPSRTrainConfig, LPSRTrainer
    from lpr_tpu_torch.utils.registry import RunRegistry
    from lpr_tpu_torch.weights.checkpoint import load_state

    dev = resolve_device(args.device)
    hw = (args.height, args.width)
    train_ds = PairedImageDataset(args.hr_train_dir, args.lr_train_dir, hw)
    val_ds = PairedImageDataset(args.hr_val_dir, args.lr_val_dir, hw)
    print(f"train {len(train_ds)} pairs, val {len(val_ds)} pairs",
          flush=True)

    trainer = LPSRTrainer(LPSRTrainConfig(lr=args.lr), LPSRConfig(),
                          device=dev)
    os.makedirs(args.ckpt_dir, exist_ok=True)

    # run-artifact registry: config + dataset fingerprint + ckpt lineage
    parent = None
    resume_path = args.resume
    data_dirs = [args.hr_train_dir, args.lr_train_dir,
                 args.hr_val_dir, args.lr_val_dir]
    registry = RunRegistry(args.runs_dir)
    if args.resume_run:
        parent = registry.latest(args.run_project, with_artifact="latest")
        if parent is None:
            raise SystemExit(f"--resume-run: no prior runs under "
                             f"{args.runs_dir}/{args.run_project}")
        if resume_path is None:
            resume_path = registry.resume_checkpoint(args.run_project)
    run = registry.new_run(args.run_project, config=vars(args),
                           dataset_dirs=data_dirs, resume_from=parent)
    print(f"run {run.id} (dataset {run.manifest['dataset_fingerprint']})",
          flush=True)

    init_params = None
    if resume_path:
        init_params = load_state(resume_path)[0]
        print(f"resumed weights from {resume_path}", flush=True)

    epoch_counter = [0]

    def train_batches():
        epoch_counter[0] += 1
        return train_ds.batches(args.batch_size, shuffle=True,
                                seed=epoch_counter[0], drop_last=True)

    def val_batches():
        return val_ds.batches(args.batch_size, shuffle=False, drop_last=True)

    state = trainer.fit(train_batches, val_batches, args.epochs,
                        ckpt_dir=args.ckpt_dir, init_params=init_params,
                        logger=lambda m: print(m, flush=True))
    best_psnr = float(state["best_psnr"])
    for fname, aliases in (("last_model.npz", ("latest",)),
                           ("best_model.npz", ("best",))):
        p = os.path.join(args.ckpt_dir, fname)
        if os.path.exists(p):
            run.log_artifact(p, aliases=aliases,
                             metrics={"best_psnr": best_psnr})
    run.finish({"best_psnr": best_psnr, "epochs": args.epochs})
    print("done; best PSNR", state["best_psnr"], flush=True)


if __name__ == "__main__":
    main()
