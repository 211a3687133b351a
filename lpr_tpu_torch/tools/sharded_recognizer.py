"""The sharded recognizer across cards against the plain recognizer.

    python -m lpr_tpu_torch.tools.sharded_recognizer
        [--devices cuda:0 cuda:1 ...] [--batch 8] [--batches 3]
        [--steps 5] [--device cpu]

``PlateRecognizer(mesh=make_mesh(devices=...))`` (one replica a device:
by default every card, or the one card twice) and the plain recognizer
on the first device, both at the main path's configuration (720p frames,
the detector at 736x1280, bf16, frozen; on the CPU float32 at 180x320
frames and a 192x320 detector) on the repo's checkpoints.  Each takes
``--batches`` distinct batches in turn, twice over (the first pass
captures each replica's graph, the second replays it).  Every sharded
output must equal, bit for bit, the plain recognizer's outputs on the
same shares of the batch, one share a call: that is the sharding's own
check (a replica that ran on the wrong stream, or replayed a stale graph,
differs).  Against the plain recognizer on the whole batch it reports,
and does not hold, the plate slots whose validity or class differs, the
boxes' largest difference where both are valid, and the plates whose
strings differ: in bf16 the detectors' library convolutions round by
batch size, so the plain recognizer's outputs on a share are not its
outputs on the whole batch (on an H100, shares of 2 frames moved a box
by 2.5 px and shares of 4 none, with 2 of 88 plates' strings apart).
``chip_smoke.py`` phase ``parallel`` holds two shares of 4 to the whole
batch with the slice's bounds.  Then it prints each side's ms a batch (the
median of ``--steps`` calls on the host clock, each ended by a
synchronize of every card) and the kernel launches of one sharded step
(on a card K1 and K2 once a replica, or it fails), beside the card's
name and power limit, and one JSON line.  Run from the repo's root (the
checkpoints' paths).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch

from lpr_tpu_torch.tools import _timing
from lpr_tpu_torch.tools.profile_stages import DET_HW, FRAME_HW

def _texts(rec, out) -> List[List[tuple]]:
    return [[(p["text"], p["text_sr"]) for p in f] for f in rec.assemble(out)]


def _launches() -> Dict[str, int]:
    from lpr_tpu_torch.kernels.lpsr import lpsr_fused
    from lpr_tpu_torch.kernels.yolo_front import yolo_front

    return {"yolo_front": yolo_front.launches + yolo_front.launches_u8,
            "lpsr": lpsr_fused.launches}


def _leaves(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    return {} if tree is None else {prefix[:-1]: tree}


def _cat(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _cat([t[k] for t in trees]) for k in trees[0]}
    return None if trees[0] is None else np.concatenate(trees)


def run(devices: List[torch.device], batch: int, batches: int,
        steps: int) -> dict:
    from lpr_tpu_torch.parallel.mesh import make_mesh, split_batch
    from lpr_tpu_torch.pipeline.recognizer import to_host
    from lpr_tpu_torch.tools.profile_stages import build_recognizer
    from lpr_tpu_torch.tools.synth import synth_frames

    first = devices[0]
    on_card = first.type == "cuda"
    if on_card:                 # both kernels' nvcc at once
        from lpr_tpu_torch.kernels import _build

        _build.build(["yolo_front", "lpsr"])
    kw = (dict(dtype=torch.bfloat16, det_hw=DET_HW) if on_card
          else dict(dtype=torch.float32, det_hw=(192, 320)))
    hw = FRAME_HW if on_card else (180, 320)
    sharded = build_recognizer(first, mesh=make_mesh(devices=devices), **kw)
    plain = build_recognizer(first, **kw)
    frames = [synth_frames(batch, hw, seed) for seed in range(batches)]

    def sync():
        for d in sorted({d.index or 0 for d in devices
                         if d.type == "cuda"}):
            torch.cuda.synchronize(d)

    box_err, plates, slots_apart, strings_apart, differ = 0.0, 0, 0, 0, []
    for rnd in ("capture", "replay"):
        for seed, f in enumerate(frames):
            got = to_host(sharded.step_raw(f))
            shares = _cat([to_host(plain.step_raw(s))
                           for s in split_batch(f, len(devices))])
            whole = to_host(plain.step_raw(f))
            a, b = _leaves(got), _leaves(shares)
            bad = [k for k in b if not np.array_equal(a[k], b[k])]
            if bad:
                differ.append(f"{rnd} batch {seed}: {bad} differ from the "
                              f"plain recognizer's on the shares")
            va, vw = got["plate_valid"], whole["plate_valid"]
            both = va & vw
            slots_apart += int(((va != vw) | (both & (
                got["plate_classes"] != whole["plate_classes"]))).sum())
            box_err = max(box_err, float(np.abs(
                got["plate_boxes"] - whole["plate_boxes"])[both].max(
                    initial=0.0)))
            strings_apart += sum(
                p != q for fa, fw in zip(_texts(plain, got),
                                         _texts(plain, whole))
                for p, q in zip(fa, fw))
            plates += int(vw.sum())
    if differ:
        raise AssertionError("the sharded recognizer differs: "
                             + "; ".join(differ))
    before = _launches()
    sharded.step_raw(frames[0])
    sync()
    launches = {k: v - before[k] for k, v in _launches().items()}
    if on_card and set(launches.values()) != {len(devices)}:
        raise AssertionError(f"a sharded step over {len(devices)} cards "
                             f"launched {launches}")

    ms = {}
    for side, rec in (("sharded", sharded), ("plain", plain)):
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            rec.step_raw(frames[0])
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        ms[side] = statistics.median(times)
    return {"devices": [str(d) for d in devices], "batch": batch,
            "batches": batches, "plates": plates,
            "whole_batch": {"slots_apart": slots_apart,
                            "box_max_abs_err": box_err,
                            "strings_apart": strings_apart},
            "ms_sharded": ms["sharded"], "ms_plain": ms["plain"],
            "launches_sharded_step": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", nargs="+", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where --devices is not "
                         "given")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.devices:
        devices = [torch.device(d) for d in args.devices]
    elif args.device == "cpu":
        devices = [torch.device("cpu")] * 2
    else:
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)] if n > 1 \
            else [torch.device("cuda", 0)] * 2
    res = run(devices, args.batch, args.batches, args.steps)
    card = _timing.card(devices[0])
    w = res["whole_batch"]
    print(f"sharded recognizer over {res['devices']} (batch {args.batch}): "
          f"every output of {2 * args.batches} calls equal to the plain "
          f"recognizer's on the same shares; against the whole batch "
          f"({res['plates']} plates) {w['slots_apart']} plate slots' "
          f"validity or class apart, boxes within {w['box_max_abs_err']} "
          f"px, {w['strings_apart']} plates' strings apart; ms a batch {res['ms_sharded']:.3f} sharded, "
          f"{res['ms_plain']:.3f} plain (median of {args.steps}); launches "
          f"a sharded step {res['launches_sharded_step']} on {card}",
          flush=True)
    print(json.dumps({**res, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
