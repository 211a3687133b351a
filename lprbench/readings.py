"""The readings that the correctness limits are set from, on the card, in
one process: the program over many seeds at a cell's own load (a short
window each, the run's own sample and comparison), then the controls on
the same seeds: the reference in the program's place in float8 e4m3
(``--control fp8``) and the program with its own int8 detector
(``--control int8``, ``PipelineConfig.int8_detector``).

    python3 lprbench/readings.py --workload lpr720.closed64 --seeds 12
        [--first-seed 7001] [--seconds 3] [--control fp8 int8]

Prints one JSON line a seed and side (``side``: program, fp8, int8), then
for each side the least and the largest reading of each number; besides
the numbers compared, the served answers end to end against the
reference's own chain (``own_chain``) and the skew-orientation gap
(program's crop in bf16 against the reference's float32 crop) behind the
reference's ``THETA_SPAN``.  Run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lprbench import check, load, run  # noqa: E402


def program_side(manifest, name, seeds, seconds, device, **changes):
    """(seed, numbers, failed) of the program at the cell's load."""
    from lprbench.frames import synth_frames
    from lprbench.ref.pipeline import Reference

    cell, cfg, mix, params, limits = run.cell_files(manifest, name)
    rec = run.build_program(cfg, device, **changes)
    ref = Reference(_abs(cfg), device)
    server = run.start_server(rec, cfg, mix)
    out = []
    try:
        for seed in seeds:
            frames = synth_frames(int(mix["distinct_frames"]),
                                  tuple(cfg["frame_hw"]), seed % 2**32)
            route = load.route(mix, server, frames)
            run.warm(route, mix)
            r = load.drive(route, mix, seconds, seed,
                           params.get("rate_fps"))
            window = [q for q in r.requests if r.t0 <= q.due < r.t1]
            failed = sum(1 for q in window if not q.answered())
            answered = [q for q in window if q.answered()]
            picked = check.sample(answered, int(mix["check_requests"]), seed)
            served = [(q.frame, q.result) for q in picked]
            nums = check.judge(served, frames, ref, limits)
            nums.update(own_chain(ref, frames, served))
            nums["theta_gap"] = theta_gap(rec, ref, frames, picked)
            out.append((seed, nums, failed))
    finally:
        server.stop()
    return out


def own_chain(ref, frames, served) -> dict:
    """The served answers end to end against the reference's own chain
    (its detections, boxes, deskew angles and SR images), on the plates
    matched as ``check.judge`` matches them: ``text_dist_e2e``, the mean
    edit share of ``text`` and ``text_sr``, and ``sr_err_e2e``, the mean
    SR image gap.  Read for the record; not a limit (``check.py``)."""
    import numpy as np

    idx = sorted({i for i, _ in served})
    dets = ref.detect(frames[idx])
    top = dict(zip(idx, (d["top"] for d in dets)))
    own = dict(zip(idx, ref.serve(frames[idx], dets)))
    text, sr = [], []
    for i, plates in served:
        for k, j in check._match(plates, top[i]).items():
            p, q = plates[k], own[i][j]
            text += [check.edit_share(p[n], q[n]) for n in ("text",
                                                             "text_sr")]
            img = np.asarray(p["sr"], np.float32).reshape(q["sr"].shape)
            sr.append(float(np.abs(img - q["sr"]).mean()))
    return {"text_dist_e2e": float(np.mean(text)) if text else 0.0,
            "sr_err_e2e": float(np.mean(sr)) if sr else 0.0}


def theta_gap(rec, ref, frames, picked) -> float:
    """The widest gap (radians) between the structure orientation of the
    program's bf16 zero-angle crop and the reference's float32 one, over
    the picked requests' served boxes, leaving out orientations near
    +-pi/2, where the angle does not jump."""
    import numpy as np
    import torch

    from lpr_tpu_torch.ops import image as im
    from lpr_tpu_torch.ops.resample import crop_rotated_fast, plate_tile
    from lprbench.ref import geometry as geo

    seen, worst = set(), 0.0
    for q in picked:
        if q.frame in seen or not q.result:
            continue
        seen.add(q.frame)
        boxes = torch.tensor(np.asarray([p["box"] for p in q.result],
                                        np.float32))[None].to(rec.device)
        u8 = torch.from_numpy(frames[q.frame][None]).to(rec.device)
        zero = torch.zeros(boxes.shape[:2], device=rec.device)
        xb = u8.to(rec.cfg.dtype) / 255.0
        tl, gm = plate_tile(xb, boxes, rec.cfg.tile_hw)
        gp = im.rgb_to_gray(crop_rotated_fast(
            xb, boxes, zero, (32, 96), tile=tl, tile_geom=gm).float())
        x = u8.float() / 255.0
        tile, g = geo.plate_tile(x, boxes, tuple(ref.cfg["tile_hw"]))
        gr = geo.gray(geo.crop(tile, g, boxes, zero, (32, 96)))
        tp, tr = geo.structure_theta(gp), geo.structure_theta(gr)
        keep = tr.abs() < 1.0
        if keep.any():
            worst = max(worst, float((tp - tr).abs()[keep].max()))
    return worst


def control_side(manifest, name, seeds, device):
    """(seed, numbers, 0) of the reference in float8 e4m3 in the program's
    place, judged on the same sample as a run."""
    from lprbench.frames import synth_frames
    from lprbench.ref.pipeline import Reference

    cell, cfg, mix, params, limits = run.cell_files(manifest, name)
    ref = Reference(_abs(cfg), device)
    low = Reference(_abs(cfg), device, fp8=True)
    out = []
    for seed in seeds:
        frames = synth_frames(int(mix["distinct_frames"]),
                              tuple(cfg["frame_hw"]), seed % 2**32)
        answers = low.serve(frames)
        n = int(mix["check_requests"])
        served = [(i % len(frames), answers[i % len(frames)])
                  for i in range(n)]
        nums = check.judge(served, frames, ref, limits)
        nums.update(own_chain(ref, frames, served))
        out.append((seed, nums, 0))
    return out


def _abs(cfg: dict) -> dict:
    return {"pipeline": cfg["pipeline"],
            "checkpoints": {k: str(ROOT / v)
                            for k, v in cfg["checkpoints"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", nargs="*", default=["fp8", "int8"])
    ap.add_argument("--control-seeds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no card", file=sys.stderr)
        return 2
    manifest = run.load_json(ROOT / "BENCHMARK.json")
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    dev = torch.device("cuda")
    sides = {"program": lambda: program_side(manifest, args.workload, seeds,
                                             args.seconds, dev)}
    ctl = seeds[:args.control_seeds]
    if "fp8" in args.control:
        sides["fp8"] = lambda: control_side(manifest, args.workload, ctl,
                                            dev)
    if "int8" in args.control:
        sides["int8"] = lambda: program_side(
            manifest, args.workload, ctl, args.seconds, dev,
            int8_detector=True)
    summary = {}
    for side, fn in sides.items():
        t = time.perf_counter()
        rows = fn()
        for seed, nums, failed in rows:
            print(json.dumps({"side": side, "seed": seed, "failed": failed,
                              **nums}), flush=True)
        summary[side] = {k: [min(r[1][k] for r in rows),
                             max(r[1][k] for r in rows)] for k in rows[0][1]}
        summary[side]["seconds"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "largest": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
