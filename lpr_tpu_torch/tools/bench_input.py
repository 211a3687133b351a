"""Input-pipeline throughput of the detector trainer (counterpart of
``tools/bench_input.py``): :class:`~lpr_tpu_torch.data.yolo_data
.YoloDataset` images/s over the full augmentation of the defaults (mosaic4
+ copy-paste + random_perspective + HSV + flips + collate) on a PNG tree
of synthetic 720p frames with labelled plates
(:func:`lpr_tpu_torch.tools.synth.write_yolo_tree`).

    python -m lpr_tpu_torch.tools.bench_input [--n 64] [--batch 16]
        [--imgsz 640] [--workers 8] [--epochs 2] [--root DIR]

Three numbers, each over whole epochs of ``batches(batch)``:

- ``cold``: no RAM cache, one thread: every image read and decoded from
  its PNG at each use;
- ``cached``: after ``cache_all`` (decoded images in RAM), one thread;
- ``workers``: cached, with ``--workers`` sample threads (the host
  library releases the interpreter lock).

It prints one JSON line with images/s of each and the machine's CPU count.
The tree is written under ``--root`` (default a temporary directory,
removed at the end).  The trainer's step rate at the same batch is in
``bench_train_step --models det``; the loader keeps up when its images/s
are above batch / step time.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def epoch_rate(ds, batch: int, epochs: int, workers: int = 0) -> float:
    """Images/s over ``epochs`` epochs of ``ds.batches``."""
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for imgs, _ in ds.batches(batch, workers=workers):
            n += imgs.shape[0]
    return n / (time.perf_counter() - t0)


def measure(img_dir: str, lbl_dir: str, batch: int, imgsz: int,
            workers: int, epochs: int) -> dict:
    from lpr_tpu_torch.data.yolo_data import YoloDataset

    hw = (imgsz, imgsz)
    cold = YoloDataset(img_dir, lbl_dir, hw, seed=0)
    rec = {"cold_imgs_per_s": epoch_rate(cold, batch, 1)}
    cached = YoloDataset(img_dir, lbl_dir, hw, seed=0, cache_images=True)
    t0 = time.perf_counter()
    gb = cached.cache_all(workers=max(workers, 1))
    rec["cache_s"] = time.perf_counter() - t0
    rec["cache_gb"] = gb
    rec["cached_imgs_per_s"] = epoch_rate(cached, batch, epochs)
    rec["workers_imgs_per_s"] = epoch_rate(cached, batch, epochs, workers)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64, help="frames in the tree")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--root", default=None,
                    help="where to write the tree (kept); default a "
                         "temporary directory, removed")
    args = ap.parse_args(argv)
    from lpr_tpu_torch.tools.synth import write_yolo_tree

    root = args.root or tempfile.mkdtemp(prefix="lpr_bench_input_")
    try:
        t0 = time.perf_counter()
        img_dir, lbl_dir = write_yolo_tree(root, args.n)
        rec = {"tool": "bench_input", "frames": args.n, "frame_hw": [720, 1280],
               "format": "png", "imgsz": args.imgsz, "batch": args.batch,
               "workers": args.workers, "write_s": time.perf_counter() - t0}
        rec.update(measure(img_dir, lbl_dir, args.batch, args.imgsz,
                           args.workers, args.epochs))
        rec["cpus"] = len(os.sched_getaffinity(0))
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
