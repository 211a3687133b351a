#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (lpr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:

1. device  — the card's name and power limit (nvidia-smi); fails without a
   CUDA device.
2. build   — every kernel in lpr_tpu_torch/csrc built with nvcc (one
   process per source, all started together), loaded with ctypes; prints
   nvcc's register / shared-memory / spill report.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes, with the tolerance stated beside it, then both
   timed with CUDA events (plain, kernel, kernel, plain).
4. slice   — PlateRecognizer at the production configuration (720p frames,
   detector at 736x1280, bf16, the repo's checkpoints) on 8 frames made
   with numpy from a fixed seed (lpr_tpu_torch.tools.synth): output shapes
   and finiteness, the K1 launch count, the detector's raw head through K1
   against the same head through the plain front, and frames/s.
5. serve   — InferenceServer(max_batch=8) answers 16 requests; the
   answers must equal the recognizer's own; then stop().

The second-to-last line is one JSON object {"kernels": [...]} (launch
counts from the serve phase, the main path a user drives); the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before that line.  A watchdog turns a hang into a failing exit with a
traceback.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time

# A whole run, the nvcc build included, measured 21-22 s on an H100; the
# watchdog turns a hang into a failing exit at about three times that.
WATCHDOG_S = 60
SEED = 0
BATCH = 8
FRAME_HW = (720, 1280)
DET_HW = (736, 1280)
CKPT_PLATE = "checkpoints/plate_det640.npz"
CKPT_CHAR = "checkpoints/char_ocr_synth.npz"
CKPT_LPSR = "checkpoints/lpsr_synth_glare/best_model.npz"
# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# K1 vs its plain version: lpr_tpu_torch.kernels.yolo_front.TOL_* (0.03 +
# two bf16 ulps elementwise over the whole tensor, interior mean 0.004).
# Detector raw head through K1 vs through the plain front (bf16): K1's
# rare one-ulp differences on layer 2 travel through 21 more bf16 layers;
# logits reach ~20 in magnitude.
HEAD_MAX_ERR = 0.5
HEAD_MEAN_ERR = 0.05

_T0 = time.perf_counter()


def phase(name: str, t_start: float, note: str = "") -> None:
    print(f"phase {name}: ok {time.perf_counter() - t_start:.2f} s "
          f"(total {time.perf_counter() - _T0:.2f} s){note}", flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events), after a
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import numpy as np
    import torch

    # ---- 1. device -----------------------------------------------------
    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi
    print(smi, flush=True)
    print(f"device: {kind} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", t)

    # ---- 2. build -------------------------------------------------------
    from lpr_tpu_torch.kernels import _build
    from lpr_tpu_torch.kernels import yolo_front as kf

    t = time.perf_counter()
    libs = _build.build()
    for name, lib in libs.items():
        for line in lib.ptxas_log:
            print(f"nvcc[{name}]: {line}", flush=True)
    smem = libs["yolo_front"].cdll.lpr_yolo_front_smem_bytes()
    phase("build", t, f"; {sorted(libs)}; yolo_front dynamic smem {smem} B")

    # ---- 3. kernels -----------------------------------------------------
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector)

    t = time.perf_counter()
    plate = load_plate_detector(CKPT_PLATE).to(torch.bfloat16)
    packed = kf.front_pack(plate)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x2 = torch.rand((2, *DET_HW, 3), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    got = kf.yolo_front(x2, packed)
    ref = kf.front_plain(x2, packed)
    torch.cuda.synchronize()
    max_err, ratio, mean_int = kf.front_errors(got, ref)
    diff = (got.float() - ref.float()).abs()
    n_ulp = int((diff > 0).sum().item())
    print(f"K1 yolo_front vs front_plain (2, {DET_HW[0]}, {DET_HW[1]}, 3) "
          f"bf16: max_abs_err {max_err}, max err/(abs {kf.TOL_ABS} + rel "
          f"{kf.TOL_REL}) {ratio} (< 1), interior mean {mean_int} "
          f"(< {kf.TOL_INTERIOR_MEAN}), {n_ulp} of {got.numel()} differ, "
          f"max |plain| {ref.float().abs().max().item()}, worst at "
          f"{[int(i) for i in torch.nonzero(diff == diff.max())[0]]}",
          flush=True)
    if not (ratio < 1.0 and mean_int < kf.TOL_INTERIOR_MEAN):
        raise AssertionError("K1 disagrees with its plain version")
    x8 = torch.rand((BATCH, *DET_HW, 3), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    iters = 20
    plain_a = time_ms(lambda: kf.front_plain(x8, packed), iters)
    k_a = time_ms(lambda: kf.yolo_front(x8, packed), iters)
    k_b = time_ms(lambda: kf.yolo_front(x8, packed), iters)
    plain_b = time_ms(lambda: kf.front_plain(x8, packed), iters)
    k_ms, plain_ms = min(k_a, k_b), min(plain_a, plain_b)
    flops, nbytes = kf.front_work(BATCH, *DET_HW)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"K1 timing at ({BATCH}, {DET_HW[0]}, {DET_HW[1]}, 3) on {card}: "
          f"kernel {k_ms:.4f} ms (runs {k_a:.4f}, {k_b:.4f}), plain "
          f"{plain_ms:.4f} ms (runs {plain_a:.4f}, {plain_b:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by}; {flops} FLOP, {nbytes} B)",
          flush=True)
    kernels = [{
        "name": "yolo_front", "route": "cuda",
        "source": "lpr_tpu_torch/csrc/yolo_front.cu",
        "replaces": "lpr_tpu/ops/pallas/yolo_front.py:461",
        "launches": None, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]
    print("kernels: " + ", ".join(
        f"{k['name']} ({k['route']}, {k['source']}, replaces "
        f"{k['replaces']})" for k in kernels), flush=True)
    phase("kernels", t)

    # ---- 4. slice -------------------------------------------------------
    from lpr_tpu_torch.ops.image import letterbox
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer, to_host)
    from lpr_tpu_torch.tools.synth import synth_frames

    t = time.perf_counter()
    char, names = load_char_ocr_npz(CKPT_CHAR)
    rec = PlateRecognizer(plate, char, load_lpsr(CKPT_LPSR),
                          PipelineConfig(det_hw=DET_HW, dtype=torch.bfloat16),
                          char_names=names)
    frames = synth_frames(BATCH, FRAME_HW, SEED)
    kf.yolo_front.launches = 0
    out = rec.step_raw(frames)
    torch.cuda.synchronize()
    slice_launches = kf.yolo_front.launches
    if slice_launches < 1:
        raise AssertionError("the slice did not launch K1")
    P = rec.cfg.max_plates
    expect = {"plate_boxes": (BATCH, P, 4), "plate_scores": (BATCH, P),
              "plate_classes": (BATCH, P), "plate_valid": (BATCH, P),
              "is_long": (BATCH, P), "sr": (BATCH, P, 32, 192, 1)}
    for grp in ("chars_orig", "chars_sr"):
        expect.update({f"{grp}.boxes": (BATCH, P, 16, 4),
                       f"{grp}.scores": (BATCH, P, 16),
                       f"{grp}.classes": (BATCH, P, 16),
                       f"{grp}.valid": (BATCH, P, 16),
                       f"{grp}.count": (BATCH, P)})
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    if sorted(flat) != sorted(expect):
        raise AssertionError(f"step outputs {sorted(flat)}")
    for k, shape in expect.items():
        v = flat[k]
        if tuple(v.shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(v.shape)} != {shape}")
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"{k}: non-finite values")
    with torch.inference_mode():
        x = torch.as_tensor(frames, device="cuda").to(torch.bfloat16) / 255.0
        lb = letterbox(x, DET_HW, fill=0.0)[0].contiguous()
        raw_k = rec.plate_model(lb, front=packed)
        raw_p = rec.plate_model.forward_from(kf.front_plain(lb, packed), 3)
    head_max = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(raw_k, raw_p))
    head_mean = max((a.float() - b.float()).abs().mean().item()
                    for a, b in zip(raw_k, raw_p))
    print(f"detector raw head, K1 vs plain front: max_abs_err {head_max} "
          f"(< {HEAD_MAX_ERR}), worst level mean {head_mean} "
          f"(< {HEAD_MEAN_ERR})", flush=True)
    if not (head_max < HEAD_MAX_ERR and head_mean < HEAD_MEAN_ERR):
        raise AssertionError("detector head through K1 disagrees")
    results = rec.assemble(to_host(out))
    n_plates = sum(len(r) for r in results)
    print(f"slice: {n_plates} plates in {BATCH} frames; first texts "
          f"{[p['text_sr'] for r in results for p in r][:6]}", flush=True)
    steps, rounds = 5, 3
    for _ in range(2):
        rec.step_raw(frames)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(rounds):
        t_run = time.perf_counter()
        for _ in range(steps):
            rec.step_raw(frames)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t_run) / steps)
    best = min(step_ms)
    print(f"slice throughput: {1e3 * BATCH / best:.3f} frames/s at the best "
          f"of {rounds} rounds of {steps} steps (ms/step {step_ms}; batch "
          f"{BATCH}, 720p, det {DET_HW[0]}x{DET_HW[1]}, bf16; host clock "
          f"around synchronize) on {card}", flush=True)
    phase("slice", t, f"; K1 launches {slice_launches}")

    # ---- 5. serve -------------------------------------------------------
    from lpr_tpu_torch.serve.server import InferenceServer, ServeConfig

    t = time.perf_counter()
    requests = np.concatenate([frames, frames])
    kf.yolo_front.launches = 0
    srv = InferenceServer(rec, ServeConfig(max_batch=BATCH,
                                           max_delay_ms=20.0)).start()
    try:
        futs = srv.submit_many(requests)
        served = [f.result(timeout=300) for f in futs]
    finally:
        srv.stop(timeout=60)
    serve_launches = kf.yolo_front.launches
    print(f"serve stats: {json.dumps(srv.stats.summary())}", flush=True)
    if serve_launches < 1:
        raise AssertionError("the server did not launch K1")

    def key(res):
        return [(p["class_id"], p["text"], p["text_sr"]) for p in res]

    if [key(r) for r in served] != [key(r) for r in results + results]:
        raise AssertionError("served results differ from recognize()")
    phase("serve", t, f"; {len(served)} requests, K1 launches "
          f"{serve_launches}")

    kernels[0]["launches"] = serve_launches
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
