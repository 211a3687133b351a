"""YOLO detector training CLI (counterpart of ``lpr_tpu/cli/train_yolo.py``,
reference ``yolov5/train.py``).

    python -m lpr_tpu_torch.cli.train_yolo --img-dir images/ \\
        --label-dir labels/ --nc 11 [--arch yolov5s|char_ocr] \\
        [--imgsz 640 | --imgsz H W] [--autoanchor] [--evolve N] \\
        [--hyp obj=1.5] [--device cpu]

Dataset layout: ``--img-dir`` with images (PNG on a machine without
libjpeg), ``--label-dir`` with YOLO-format .txt labels of the same stems.
Each run is recorded in the run registry (:mod:`lpr_tpu_torch.utils
.registry`): its config, the dataset fingerprint, ``last.npz`` as
``latest`` and ``best.npz`` as ``best``; per-epoch metrics go to
``results.csv`` in ``--ckpt-dir`` (:mod:`lpr_tpu_torch.utils.loggers`).
``--evolve`` writes ``evolve.csv`` and ``hyp_evolve.yaml`` (the text
``yaml.safe_dump`` writes, produced without the yaml package).

Data parallelism: one process a device, started with the env contract of
:mod:`lpr_tpu_torch.parallel.multiproc` (``COORDINATOR_ADDRESS``,
``WORLD_SIZE``, ``RANK``).  ``--batch-size`` is then the global batch;
each rank trains a strided, equal-length subset of the images
(``[:n][r::w]``) with the global batch statistics and positive count
(:class:`~lpr_tpu_torch.train.yolo.YoloTrainer` with a mesh), and every
rank validates the whole set, so early stopping and ``--evolve``'s
choices agree across ranks.  Rank 0 alone writes checkpoints, plots,
``evolve.csv``, ``hyp_evolve.yaml`` and the registry.
``--data-parallel`` without that env (``WORLD_SIZE`` above 1) raises:
one process drives one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

DEFAULT_HYP = {
    "lr0": 0.01, "lrf": 0.01, "momentum": 0.937,
    "weight_decay": 5e-4, "warmup_epochs": 3.0, "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1, "box": 0.05, "cls": 0.5, "cls_pw": 1.0,
    "obj": 1.0, "obj_pw": 1.0, "anchor_t": 4.0, "fl_gamma": 0.0,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0,
    "translate": 0.1, "scale": 0.5, "shear": 0.0, "perspective": 0.0,
    "flipud": 0.0, "fliplr": 0.5, "mosaic": 1.0, "mixup": 0.0,
    "copy_paste": 0.0,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a YOLO detector")
    p.add_argument("--img-dir", required=True)
    p.add_argument("--label-dir", default=None)
    p.add_argument("--val-img-dir", default=None)
    p.add_argument("--val-label-dir", default=None)
    p.add_argument("--arch", default="yolov5s",
                   help="yolov5n/s/m/l/x or char_ocr")
    p.add_argument("--nc", type=int, required=True)
    p.add_argument("--imgsz", type=int, nargs="+", default=[640],
                   help="square size, or 'H W' for rectangular training/val")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr0", type=float, default=0.01)
    p.add_argument("--max-labels", type=int, default=64)
    p.add_argument("--ckpt-dir", default="checkpoints/yolo")
    p.add_argument("--init-weights", default=None,
                   help="warm-start from an .npz checkpoint (fully "
                        "convolutional: any input geometry)")
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--workers", type=int, default=8,
                   help="loader threads (0 = synchronous)")
    p.add_argument("--cache", action="store_true",
                   help="decode images into RAM once (reference --cache ram)")
    p.add_argument("--data-parallel", action="store_true",
                   help="data parallelism: needs the env "
                        "COORDINATOR_ADDRESS/WORLD_SIZE/RANK with "
                        "WORLD_SIZE above 1 (one process a card), which "
                        "alone also turns it on")
    p.add_argument("--autoanchor", action="store_true",
                   help="evolve anchors from the train labels first")
    p.add_argument("--evolve", type=int, default=0, metavar="N",
                   help="genetic hyperparameter evolution: N generations of "
                        "--epochs-long trainings (reference "
                        "train.py:538-620); writes evolve.csv + "
                        "hyp_evolve.yaml to --ckpt-dir, then trains the "
                        "final model with the winning hyps")
    p.add_argument("--evolve-seed", type=int, default=0)
    p.add_argument("--hyp", action="append", default=[], metavar="K=V",
                   help="override a hyperparameter gene by name; repeatable")
    p.add_argument("--runs-dir", default="runs",
                   help="run-artifact registry root")
    p.add_argument("--run-project", default="yolo")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def hyp_yaml(fitness: float, hyp) -> str:
    """``yaml.safe_dump({"fitness": fitness, "hyp": hyp})`` for float
    values and plain identifier keys: keys sorted, block style."""
    from lpr_tpu_torch.config import dump

    return dump({"fitness": float(fitness),
                 "hyp": {k: float(hyp[k]) for k in sorted(hyp)}})


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from lpr_tpu_torch.data.yolo_data import YoloAugConfig, YoloDataset
    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.models.yolo import (_SIZE_PRESETS, build_yolo,
                                           char_ocr_spec, yolov5_spec)
    from lpr_tpu_torch.parallel.mesh import make_mesh
    from lpr_tpu_torch.parallel.multiproc import (DATA_PARALLEL_NEEDS_ENV,
                                                  initialize_from_env,
                                                  is_main_process,
                                                  rank_share)
    from lpr_tpu_torch.train.yolo import (YoloTrainConfig, YoloTrainer,
                                          fit_yolo, fitness, validate_map)
    from lpr_tpu_torch.train.yolo_loss import YoloLossConfig
    from lpr_tpu_torch.utils.callbacks import Callbacks
    from lpr_tpu_torch.utils.loggers import Loggers

    if args.data_parallel and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        raise SystemExit(DATA_PARALLEL_NEEDS_ENV)
    dev = resolve_device(args.device)
    dist = initialize_from_env(dev)
    if dist and dev.type == "cuda":
        import torch

        dev = torch.device("cuda", torch.cuda.current_device())
    main_proc = is_main_process()

    def log(msg):
        if main_proc:
            print(msg, flush=True)

    if len(args.imgsz) not in (1, 2):
        raise SystemExit("--imgsz takes one int (square) or two (H W)")
    hw = (tuple(args.imgsz * 2)[:2] if len(args.imgsz) == 1
          else tuple(args.imgsz))
    train_ds = YoloDataset(args.img_dir, args.label_dir, hw,
                           max_labels=args.max_labels,
                           augment=not args.no_augment,
                           cache_images=args.cache)
    val_ds = YoloDataset(args.val_img_dir or args.img_dir,
                         args.val_label_dir or args.label_dir, hw,
                         max_labels=args.max_labels, augment=False,
                         cache_images=args.cache)
    log(f"train {len(train_ds)} images, val {len(val_ds)} images")
    if args.cache:
        log(f"cached {train_ds.cache_all():.2f} GB of decoded images in RAM")

    ckpt_anchors = None
    if args.arch == "char_ocr":
        spec = dataclasses.replace(char_ocr_spec(), nc=args.nc)
        strides = (8,)
        ckpt_anchors = np.ones((1, 2, 2), np.float32) * 2
    else:
        size = args.arch.replace("yolov5", "") or "s"
        if size not in _SIZE_PRESETS:
            raise SystemExit(f"--arch: unknown {args.arch!r} (yolov5n/s/m/"
                             f"l/x or char_ocr)")
        depth, width = _SIZE_PRESETS[size]
        spec = yolov5_spec(nc=args.nc, depth=depth, width=width)
        strides = (8, 16, 32)

    if args.autoanchor:
        from lpr_tpu_torch.utils.autoanchor import kmeans_anchors

        whs = []
        for i in range(min(len(train_ds), 500)):
            _, labels = train_ds.get(i)
            v = labels[labels[:, 3] > 0]
            whs.append(v[:, 3:5] * np.asarray([hw[1], hw[0]], np.float32))
        wh = np.concatenate(whs) if whs else np.zeros((0, 2))
        if len(wh) >= 8:
            n_anchors = 2 if args.arch == "char_ocr" else 9
            evolved = kmeans_anchors(wh, n=n_anchors)
            nl = len(strides)
            ckpt_anchors = (evolved.reshape(nl, n_anchors // nl, 2)
                            / np.asarray(strides, np.float32)[:, None, None])
            log(f"evolved anchors (grid units): {ckpt_anchors.tolist()}")

    model = build_yolo(spec, ckpt_anchors=ckpt_anchors, strides=strides)

    # one flat hyp vector over the aug, loss and optimizer genes (the
    # reference's hyp.yaml contract); without --evolve training uses it
    hyp = dict(DEFAULT_HYP, lr0=args.lr0)
    for kv in args.hyp:
        k, _, v = kv.partition("=")
        if k not in hyp:
            raise SystemExit(f"--hyp: unknown key {k!r} (valid: "
                             f"{sorted(hyp)})")
        hyp[k] = float(v)

    def make_cfgs(h):
        aug = YoloAugConfig(
            hsv_h=h["hsv_h"], hsv_s=h["hsv_s"], hsv_v=h["hsv_v"],
            degrees=h["degrees"], translate=h["translate"], scale=h["scale"],
            shear=h["shear"], perspective=h["perspective"],
            flipud=h["flipud"], fliplr=h["fliplr"], mosaic=h["mosaic"],
            mixup=h["mixup"], copy_paste=h["copy_paste"])
        loss = YoloLossConfig(
            box=h["box"], obj=h["obj"], cls=h["cls"], cls_pw=h["cls_pw"],
            obj_pw=h["obj_pw"], anchor_t=h["anchor_t"])
        tcfg = YoloTrainConfig(
            lr0=h["lr0"], lrf=h["lrf"], momentum=h["momentum"],
            weight_decay=h["weight_decay"], warmup_epochs=h["warmup_epochs"],
            warmup_momentum=h["warmup_momentum"],
            warmup_bias_lr=h["warmup_bias_lr"], epochs=args.epochs)
        return aug, loss, tcfg

    batch_size = args.batch_size
    if dist:     # the global batch; the RAM cache is keyed by path
        train_ds.paths, batch_size = rank_share(train_ds.paths,
                                                args.batch_size)
    mesh = make_mesh(devices=[dev]) if dist else None
    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    os.makedirs(args.ckpt_dir, exist_ok=True)

    init_params = None
    if args.init_weights:
        from lpr_tpu_torch.weights.checkpoint import load_state

        init_params = load_state(args.init_weights)[0]
        log(f"warm-started from {args.init_weights}")

    def train_batches():
        return train_ds.batches(batch_size, workers=args.workers)

    def val_batches():
        return val_ds.batches(batch_size, shuffle=False,
                              workers=args.workers)

    if args.evolve:
        from lpr_tpu_torch.utils.evolve import evolve

        def train_and_eval(cand):
            aug_cfg, loss_cfg, tcfg = make_cfgs(cand)
            train_ds.aug = aug_cfg
            t = YoloTrainer(model, tcfg, loss_cfg=loss_cfg,
                            steps_per_epoch=steps_per_epoch, mesh=mesh,
                            device=dev)
            state = fit_yolo(t, train_batches, val_batches,
                             epochs=args.epochs, ckpt_dir=None,
                             patience=args.patience, logger=lambda m: None,
                             init_params=init_params)
            # every rank validates the whole set with the same EMA weights,
            # and the mutations are seeded, so every rank's evolution
            # keeps in step without a broadcast
            metrics = validate_map(model, state["ema"], val_batches(),
                                   device=dev)
            fit = fitness(metrics)
            log(f"  candidate fitness {fit:.4f} (mAP50 "
                f"{metrics['map50']:.4f} mAP {metrics['map']:.4f})")
            return fit

        csv_path = os.path.join(args.ckpt_dir, "evolve.csv")
        log(f"evolving {args.evolve} generations of {args.epochs}-epoch "
            f"trainings -> {csv_path}")
        hyp, best_fit = evolve(hyp, train_and_eval, generations=args.evolve,
                               seed=args.evolve_seed,
                               log_path=csv_path if main_proc else None)
        if main_proc:
            with open(os.path.join(args.ckpt_dir, "hyp_evolve.yaml"),
                      "w") as f:
                f.write(hyp_yaml(float(best_fit), hyp))
        log(f"evolution done: best fitness {best_fit:.4f}; training the "
            f"final model with the winning hyps")

    aug_cfg, loss_cfg, tcfg = make_cfgs(hyp)
    train_ds.aug = aug_cfg
    trainer = YoloTrainer(model, tcfg, loss_cfg=loss_cfg,
                          steps_per_epoch=steps_per_epoch, mesh=mesh,
                          device=dev)
    callbacks = run = None
    if main_proc:
        loggers = Loggers(args.ckpt_dir)
        callbacks = Callbacks()
        callbacks.register_action(
            "on_fit_epoch_end", "csv",
            lambda epoch, m: loggers.log({"map50": m["map50"],
                                          "map": m["map"],
                                          "fitness": fitness(m)}, epoch))

        # label statistics before training (reference plot_labels); None
        # where matplotlib does not import
        from lpr_tpu_torch.eval.plots import plot_labels

        lab_rows = []
        for i in range(min(len(train_ds), 1000)):
            lab = np.asarray(train_ds._load_raw(i)[1])
            if lab.ndim == 2 and lab.shape[1] == 5 and len(lab):
                lab_rows.append(lab)
        if lab_rows:
            plot_labels(np.concatenate(lab_rows),
                        os.path.join(args.ckpt_dir, "labels.png"))

        from lpr_tpu_torch.utils.registry import RunRegistry

        run = RunRegistry(args.runs_dir).new_run(
            args.run_project, config=vars(args),
            dataset_dirs=[d for d in (args.img_dir, args.label_dir,
                                      args.val_img_dir, args.val_label_dir)
                          if d])
        log(f"run {run.id} (dataset {run.manifest['dataset_fingerprint']})")

    state = fit_yolo(trainer, train_batches, val_batches,
                     epochs=args.epochs,
                     ckpt_dir=args.ckpt_dir if main_proc else None,
                     patience=args.patience, logger=log,
                     callbacks=callbacks, init_params=init_params)
    if run is not None:
        for fname, aliases in (("last.npz", ("latest",)),
                               ("best.npz", ("best",))):
            p = os.path.join(args.ckpt_dir, fname)
            if os.path.exists(p):
                run.log_artifact(p, aliases=aliases)
        run.finish({"epochs": args.epochs, **state.get("summary", {})})
    if dist:
        # every rank returns once rank 0 has recorded the run, so that a
        # next run's --resume-run finds it on every rank
        import torch.distributed as tdist

        tdist.barrier()
    return state


if __name__ == "__main__":
    main()
