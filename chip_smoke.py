#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (lpr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:

1. device  — the card's name and power limit (nvidia-smi); fails without a
   CUDA device.
2. build   — every kernel in lpr_tpu_torch/csrc (yolo_front K1 with its
   uint8 instance and its K4 stage variants, lpsr K2, yolo_mid K3,
   conv_int8 I1 and I2) built
   with nvcc (one process per source, all started together), loaded with
   ctypes; prints nvcc's register / shared-memory / spill report and the
   HMMA (tensor-core mma) instructions by cuobjdump -sass in
   lpsr_kernel<bf16> and lpsr_kernel<float>, in K1's front_kernel
   instances but the dma one (the bf16 stages and the uint8 FULL instance)
   and in K3's mid_kernel (fails if lpsr_kernel<bf16>, lpsr_kernel<float>,
   front_kernel<FULL, bf16>, front_kernel<FULL, uint8_t> or mid_kernel has
   none), the IGMMA (the warpgroup MMA on int8, wgmma) instructions in
   each of the 50 instances of I2's conv_int8_kernel (fails if one has
   none), and nvcc's registers and spills for the uint8 instance,
   mid_kernel and each kernel of I1 and I2.  Then the host libraries with g++
   (csrc/host_letterbox.cc always; csrc/host_decode.cc, which links
   libjpeg and libpng, where g++ finds their headers, else one line says
   that the decode calls are not driven and why), each g++ command
   printed.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes (K1 on frames in bf16 and on uint8 frames with
   1/255 folded into its stem, K2 on 24 plate crops in bf16 and float32,
   K3 on K1's output for 8 frames; the real weights), with the tolerance
   stated beside it, then both timed with CUDA events (plain, kernel,
   kernel, plain).  K1 (both inputs) also at the further shapes of
   tests/test_torch_front.py, and a launch with a pack that is not
   bf16-exact must raise ValueError; beside K1 the model's own layers 0-2
   in bf16 through cuDNN (for the uint8 instance on bf16(u8) / 255), the
   composed library yardstick (its library_ms).  K2 also at the further
   shapes of tests/test_torch_lpsr_kernel.py in bf16 and float32, and
   beside it LPSR.forward in bf16, the composed library yardstick (its
   library_ms).
   K3 also on K1's output for the further frames of tests/test_torch_mid.py
   and on its random front grids (one with a ragged tile in both axes), a
   launch with a pack that is not bf16-exact must raise ValueError, and
   beside it the model's own layers 3-4 in bf16 through cuDNN, the
   composed library yardstick (its library_ms).
4. probe   — K4, K1's four stage variants (dma, stem, down, full; one
   instance each of the K1 source): the probe tool's timing of them at
   (8, 736, 1280, 3) (K4's path, with its launch counts), then each
   against its plain version on the same frames and real weights (dma
   exact, stem and down within K1's bound, full bit-identical to K1's
   output in phase kernels), timed (plain, kernel, kernel, plain) beside
   its bound and the model's own layers computing the same stage through
   cuDNN (stem: layer 0, down: layers 0-1, full: layers 0-2; none for
   dma).
5. int8    — the int8 plate detector as int8_detector builds it
   (plate_det640.npz quantized from float32, then bf16; K1 for layers
   0-2) on the slice's 8 letterboxed frames: one forward records every
   int8 conv's input, residual and plan and every I1 call (it must be one
   max pass, 43 quantizes and 50 convs, and every carried max equal to the
   plain max|x| of the quantized input); at each of the 20 distinct
   (weight, input) shapes, on the real input, I1's max pass and its
   quantize from 1-4 slots, I2's int32 sums and all 24 of its epilogue
   instances (bf16 and float32 x act none/silu/leaky x residual x max)
   equal to the plain versions bit for bit; each conv as the step runs it
   and each I1 call timed (plain, kernel, kernel, plain; each run a CUDA
   graph of 10 calls, so device time) beside its bound, the library's one
   call for the same function where there is one (the max pass:
   torch.linalg.vector_norm(x, inf); I2: torch._int_mm on the im2col of
   the codes; the quantize has none), and cuDNN's bf16 conv of the same
   shape; the sums over the step, and each kernel's largest gap to its
   plain version over the checks, go into the kernels line.
6. slice   — PlateRecognizer at the production configuration (720p frames,
   detector at 736x1280, bf16, the repo's checkpoints, the step frozen
   into a CUDA graph as freeze_params does by default) on 8 frames made
   with numpy from a fixed seed (lpr_tpu_torch.tools.synth): the first
   step captures the graph, the second replays it with the launch counts
   read around it (K1 and K2); output shapes and finiteness; the graph's
   outputs equal to the eager step's bit for bit; the detector's raw head
   through K1 against the same head through the plain front; frames/s of
   the frozen and of the eager step.  Then the same with
   PipelineConfig(packed_input=True) (the host letterbox, K1's uint8
   instance), with PipelineConfig(fused_mid=True) (K1 + K3), with
   PipelineConfig(int8_detector=True) (K1, I1, I2, K2; a step must
   launch I1's max pass once, its quantize 43 times and I2 50 times; its
   plates and strings beside the bf16 step's, boxes of frames whose
   plates are valid in both within 6 px) and with PipelineConfig(lazy_decode=False) (boxes
   and scores within 1e-3 of the lazy step's).
7. stages  — the default slice's step split by stage
   (lpr_tpu_torch.tools.profile_stages, one short round): host ms,
   device-busy ms, kernels executed and host launches per stage, the step
   as a graph replay and, beside it, op by op; then each stage as the
   frozen step runs it (a device stage captured alone as a CUDA graph).
8. serve   — InferenceServer(max_batch=8) answers 16 requests through the
   frozen step; the answers must equal the recognizer's own; then stop().
   Then, each path with the launch counts set to 0 before it and read
   after it (K1 and K2 must have launched; K1's uint8 instance in the
   packed pool), each answer equal to recognize() on the same frames: the
   8 frames as PNG files through submit_path and submit_paths and as bytes
   through submit_bytes (lossless, at the served shape), one PNG at
   360x640 through submit_bytes (against recognize() on the port's Pillow
   bilinear resample of it, centred), the device-resident pool (preload,
   submit_ref) of the default recognizer and of the packed_input one, and
   HttpFrontend on 127.0.0.1 with every route (health, infer, infer_batch,
   stats).
9. apps    — the apps a user runs, each with the launch counts set to 0
   before it and read after it: cli/evaluate (its main, --per-image
   --json-out, batch 64, float32) over tests/fixtures/real_plates,
   real_plates2 and real_plates_cn, where K2 must launch per folder and the
   raw strings must equal the CPU evaluator's (at most one SR string a
   folder may differ), with acc/CER raw and SR and the evaluator's
   images/s at batch 64; K2's float32 instance at N = 64 and N = 1 against
   its plain version (float32 TOL_*), timed (plain, kernel, kernel, plain)
   beside the float32 LPSR.forward through cuDNN with TF32 off (its
   library_ms, best of 3 rounds; the entry lpsr_f32, launches from the
   evaluator), its bound as 3xTF32 on the tensor cores (bound_ms: every
   multiply-add three times at the TF32 rate) and, printed only, the same
   work at the float32 CUDA-core peak; cli/sr on
   tests/fixtures/real_lr_strips (K2; its PNGs read back, (32, 192, 3) and
   within 1 LSB of the CPU run's); cli/run on the demo frame (12 copies,
   batch 4, --panel, the default 1280x1280 bf16 detector; K1 and K2; the
   printed plates equal to recognize(); PNGs written; its frames/s);
   cli/find_improvement on real_plates (panels written, K2 launches);
   cli/serve as a process on a free port: one .npy frame POSTed to
   /v2/models/pipeline/infer answers as recognize() does, then SIGINT must
   end it with exit code 0.
10. export — the weights and export surface on the card (temporary
   files only): plate_det640.npz written as a YOLOv5 .pt
   (tests/pt_fixture.py: a pickled Model of stand-in classes) and read
   back by load_yolo_torch without running pickled code: K1's pack and
   output, and the recognizer's eager step, equal to the npz detector's
   bit for bit (the step launches K1 once and K2 once, no other kernel);
   char_ocr_synth.npz the same way
   through load_char_detector, its detections on 8 plate crops equal to
   the npz's; LPSR emitted as ONNX and loaded back, K2 float32 (64 crops)
   and bf16 (24 crops) on it equal to K2 on the npz model bit for bit;
   run_onnx on the card against LPSR.forward (float32, within
   ONNX_RUN_TOL); export_lpsr and export_detector (the .pt detector at
   736x1280) to .pt2 programs, loaded back and run on the card against the
   forwards (within PT2_TOL).
11. serving — lpr_tpu_torch.tools.bench_serving, briefly (16 clients x 4
   requests, max_batch 8), with frames, with the pool, over HTTP and, where
   host_decode built, with files: its JSON lines (client frames/s, latency
   p50/p99, mean batch, the card).
12. bench  — lpr_tpu_torch.bench (batch 32, 30 chained steps, BENCH_REPS=2)
   with BENCH_PACKED=1 and =0, and BENCH_PACKED=1 with BENCH_INT8=1 (which
   must launch I1's two kernels and I2): its JSON lines (frames/s, flops_per_frame,
   mfu_pct against the bf16 peak, the card).

Each path is driven with every launch count set to 0 just before it and
read just after; a graph replay adds to each count the launches the
graph holds.  The second-to-last line is one JSON object {"kernels":
[...]} (launch counts of K1's bf16 instance and K2 from the serve phase's
16 requests, the main path a user drives, of K1's uint8 instance from the
packed_input slice, of K3 from the fused_mid slice, of I1's max pass
(act_amax) and quantize (quantize_act) and of I2 from the int8_detector
slice, of each K4 variant from the probe phase, of K2's
float32 instance, lpsr_f32, from the evaluator in phase apps); the last
line is {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero before that line.  A watchdog turns a hang into
a failing exit with a traceback.
"""

from __future__ import annotations

import faulthandler
import io
import json
import os
import subprocess
import sys
import time

# A whole run, the nvcc builds (all started together; K2's, the longest,
# about a minute) included, measured 101-167 s on an H100 before the int8
# phase; the watchdog turns a hang into a failing exit inside the check's
# 1200 s.
WATCHDOG_S = 900
SEED = 0
BATCH = 8
FRAME_HW = (720, 1280)
DET_HW = (736, 1280)
CKPT_PLATE = "checkpoints/plate_det640.npz"
CKPT_CHAR = "checkpoints/char_ocr_synth.npz"
CKPT_LPSR = "checkpoints/lpsr_synth_glare/best_model.npz"
# K1 vs its plain version: lpr_tpu_torch.kernels.yolo_front.TOL_* (0.03 +
# two bf16 ulps elementwise over the whole tensor, interior mean 0.004).
# K2 vs its plain version: lpr_tpu_torch.kernels.lpsr.TOL_MAX / TOL_MEAN
# (bf16: max 4e-2, mean 1e-3 on the sigmoid output; float32 1e-4, 1e-5).
# K3 vs its plain version: lpr_tpu_torch.kernels.yolo_mid.TOL_* (0.05 +
# two bf16 ulps elementwise, interior mean 0.006).
# Detector raw head through K1 (and K3) vs through the plain versions
# (bf16): the kernels' rare one-ulp differences travel through the later
# bf16 layers; logits reach ~20 in magnitude.
HEAD_MAX_ERR = 0.5
HEAD_MEAN_ERR = 0.05
LPSR_N = BATCH * 3      # plate crops per step: batch x max_plates
LPSR_HW = (32, 192)
# K1's further shapes (B, H, W): as tests/test_torch_front.py's.
K1_SHAPES = [(1, 1280, 1280), (1, 64, 128), (3, 32, 64)]
# K3's further inputs: K1's output for frames (B, H, W) and random front
# grids (B, H4, W4, 64), as tests/test_torch_mid.py's.
K3_FRONT_SHAPES = [(2, 736, 1280), (1, 1280, 1280)]
K3_RANDOM_SHAPES = [(3, 20, 36, 64), (1, 16, 32, 64)]
# K2's further shapes (N, H, W): as tests/test_torch_lpsr_kernel.py's.
K2_SHAPES = [(1, 32, 192), (7, 32, 192), (2, 16, 96), (2, 48, 200),
             (3, 8, 64), (1, 8, 400)]

# The apps phase's inputs: the repo's plate crops (ground truth in the file
# names), its low-resolution strips and its demo frame.
EVAL_FOLDERS = ["tests/fixtures/real_plates", "tests/fixtures/real_plates2",
                "tests/fixtures/real_plates_cn"]
EVAL_BATCH = 64
LR_STRIPS = "tests/fixtures/real_lr_strips"
DEMO_FRAMES = "tests/fixtures/real_frames"
# cli/run's frames/s: the demo frame this many times, in batches of 4.
RUN_FRAMES = 12
# The card's SR strings may differ from the CPU's (float32 sums in another
# order move a character's score across the threshold) in this many images
# of a folder; the raw strings may not differ at all.
SR_DIFF_MAX = 1
SERVE_TIMEOUT_S = 240
# I2's instances: (bf16, float32 out x 3 acts x residual x max, + the raw
# sums) x N tiles 64 and 128.
I2_INSTANCES = 50
# The export phase: the ONNX executor (float32, F.conv2d with TF32 off)
# against LPSR.forward; a .pt2 program against the module's forward
# (absolute on the LPSR output in (0, 1), relative to 1 + |pred| on the
# detector's pixel coordinates).
ONNX_RUN_TOL = 1e-5
PT2_TOL = 1e-5


def _wall(fn) -> float:
    """Seconds of one call of fn on the host clock."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def apps_phase(card, counts_to_zero, counts, timed, iters):
    """Phase apps: the evaluator, K2's float32 instance, cli/sr, cli/run,
    cli/find_improvement and cli/serve on the card; returns (the
    ``lpsr_f32`` kernels entry, a note for the phase line)."""
    import contextlib
    import queue
    import shutil
    import signal
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from lpr_tpu_torch import imageio
    from lpr_tpu_torch.cli import evaluate as cli_evaluate
    from lpr_tpu_torch.cli import find_improvement as cli_fi
    from lpr_tpu_torch.cli import run as cli_run
    from lpr_tpu_torch.cli import serve as cli_serve
    from lpr_tpu_torch.cli import sr as cli_sr
    from lpr_tpu_torch.kernels import lpsr as kl
    from lpr_tpu_torch.kernels.conv_int8 import PEAK_FP32_FLOPS
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.tools import _timing, bench_sr_convs

    weights = ["--sr-weights", CKPT_LPSR, "--ocr-weights", CKPT_CHAR]
    note = {}
    tmp = tempfile.mkdtemp(prefix="lpr_apps_")
    try:
        # 1. the evaluator (cli/evaluate) on the card against the CPU
        cpu_ev = cli_evaluate.build_evaluator(CKPT_CHAR, CKPT_LPSR, "cpu")
        eval_launches = 0
        for folder in EVAL_FOLDERS:
            js = os.path.join(tmp, "eval.json")
            counts_to_zero()
            cli_evaluate.main(["--eval-folder", folder, *weights, "--batch",
                               str(EVAL_BATCH), "--per-image", "--json-out",
                               js])
            torch.cuda.synchronize()
            c = counts()
            if c["lpsr"] < 1:
                raise AssertionError(f"evaluate {folder} did not launch K2: "
                                     f"{c}")
            eval_launches += c["lpsr"]
            with open(js) as f:
                got = json.load(f)
            ref = cpu_ev.evaluate_folder(folder, batch_size=16)
            raw_diff = [(g["gt"], g["raw"], r["raw"]) for g, r in
                        zip(got["per_image"], ref.per_image)
                        if g["raw"] != r["raw"]]
            sr_diff = [(g["gt"], g["sr"], r["sr"]) for g, r in
                       zip(got["per_image"], ref.per_image)
                       if g["sr"] != r["sr"]]
            print(f"evaluate {folder} on {card}: n {got['n']}, acc raw "
                  f"{got['acc_raw']} sr {got['acc_sr']}, CER raw "
                  f"{got['cer_raw']} sr {got['cer_sr']}; CPU: acc raw "
                  f"{ref.acc_raw} sr {ref.acc_sr}, CER raw {ref.cer_raw} sr "
                  f"{ref.cer_sr}; K2 launches {c['lpsr']}; raw strings "
                  f"differing from the CPU's (gt, card, cpu) {raw_diff}; "
                  f"SR strings differing {sr_diff} (at most {SR_DIFF_MAX})",
                  flush=True)
            if (got["n"] != ref.n or len(got["per_image"]) != ref.n
                    or raw_diff or len(sr_diff) > SR_DIFF_MAX):
                raise AssertionError(f"evaluate {folder}: the card's "
                                     f"strings disagree with the CPU's")
        # images/s at batch 64: the plates of the three folders repeated to
        # one full batch, host preparation and device batch timed apart
        ev = cli_evaluate.build_evaluator(CKPT_CHAR, CKPT_LPSR, "cuda")
        plates, gts = [], []
        for folder in EVAL_FOLDERS:
            for f in imageio.list_images(folder):
                plates.append(imageio.read_rgb(os.path.join(folder, f)))
                gts.append(os.path.splitext(f)[0].upper())
        plates = (plates * EVAL_BATCH)[:EVAL_BATCH]
        gts = (gts * EVAL_BATCH)[:EVAL_BATCH]
        ev.evaluate_arrays(plates, gts, EVAL_BATCH)           # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            ev.evaluate_arrays(plates, gts, EVAL_BATCH)
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        prepped = [ev._prep_host(x) for x in plates]
        prep_s = time.perf_counter() - t0
        oc = np.stack([p[0] for p in prepped])
        si = np.stack([p[1] for p in prepped])
        dev_oc, dev_si = (torch.from_numpy(oc).cuda(),
                          torch.from_numpy(si).cuda())
        batch_ms = _timing.event_ms(lambda: ev._device_batch(dev_oc, dev_si),
                                    5)
        ips = EVAL_BATCH / min(walls)
        print(f"evaluator at batch {EVAL_BATCH} float32 on {card}: "
              f"{ips:.1f} images/s end to end (best of walls {walls} s), "
              f"host preparation {prep_s * 1e3:.1f} ms a batch, device "
              f"batch {batch_ms:.3f} ms (SR, canvases, char OCR on "
              f"{2 * EVAL_BATCH} images, NMS)", flush=True)
        note["evaluate"] = f"{ips:.1f} images/s"

        # 2. K2's float32 instance at the evaluator's shapes
        model32 = load_lpsr(CKPT_LPSR)
        packed32 = kl.lpsr_pack(model32)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        k2 = {}
        for n in (EVAL_BATCH, 1):
            x = torch.rand((n, *LPSR_HW, 3), generator=gen, device="cuda")
            got = kl.lpsr_fused(x, packed32)
            ref = kl.lpsr_plain(x, packed32)
            torch.cuda.synchronize()
            max_err, mean_err = kl.lpsr_errors(got, ref)
            tol_max, tol_mean = (kl.TOL_MAX[torch.float32],
                                 kl.TOL_MEAN[torch.float32])
            print(f"K2 lpsr_fused vs lpsr_plain {(n, *LPSR_HW, 3)} float32: "
                  f"max_abs_err {max_err} (< {tol_max}), mean {mean_err} "
                  f"(< {tol_mean}), finite "
                  f"{bool(torch.isfinite(got).all())}", flush=True)
            if not (max_err < tol_max and mean_err < tol_mean
                    and torch.isfinite(got).all()):
                raise AssertionError(f"K2 float32 disagrees with its plain "
                                     f"version at N = {n}")
            k_ms, plain_ms, runs = timed(lambda: kl.lpsr_fused(x, packed32),
                                         lambda: kl.lpsr_plain(x, packed32),
                                         iters)
            with torch.inference_mode():
                lib_ms = bench_sr_convs.lpsr_forward_ms(model32, x, iters,
                                                        rounds=3)
            # The bound of the instance's own route, 3xTF32 on the tensor
            # cores: every multiply-add three times at the TF32 rate.  The
            # float32 CUDA-core figure is printed beside it, not used.
            flops, nbytes = kl.lpsr_work(n, *LPSR_HW, in_bytes=4)
            bound_ms, bound_by = _timing.bound_ms((3 * flops, nbytes),
                                                  _timing.PEAK_TF32_FLOPS)
            core_ms, _ = _timing.bound_ms((flops, nbytes), PEAK_FP32_FLOPS)
            print(f"K2 float32 timing at ({n}, {LPSR_HW[0]}, {LPSR_HW[1]}, "
                  f"3) on {card}: kernel {k_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (runs {runs}), library (composed "
                  f"LPSR.forward float32, cuDNN, TF32 off; best of 3 rounds) "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                  f"3xTF32: {flops} FLOP x 3 at "
                  f"{_timing.PEAK_TF32_FLOPS:.3g} FLOP/s TF32, {nbytes} B; "
                  f"kernel/bound {k_ms / bound_ms:.2f}); at the float32 "
                  f"CUDA-core peak {PEAK_FP32_FLOPS:.3g} FLOP/s "
                  f"{core_ms:.4f} ms (kernel/that {k_ms / core_ms:.2f})",
                  flush=True)
            k2[n] = {"max_abs_err": max_err, "ms": k_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
        entry = {"name": "lpsr_f32", "route": "cuda",
                 "source": "lpr_tpu_torch/csrc/lpsr.cu",
                 "replaces": "lpr_tpu/ops/pallas/lpsr_kernel.py:235",
                 "launches": eval_launches, **k2[EVAL_BATCH]}

        # 3. cli/sr on the low-resolution strips, card against CPU
        sr_dirs = {}
        for dev in ("cuda", "cpu"):
            sr_dirs[dev] = os.path.join(tmp, f"sr_{dev}")
            counts_to_zero()
            names = cli_sr.main(["--weights", CKPT_LPSR, "--input-dir",
                                 LR_STRIPS, "--output-dir", sr_dirs[dev],
                                 "--device", dev])
            if dev == "cuda":
                torch.cuda.synchronize()
                sr_launches = counts()["lpsr"]
                if sr_launches < 1:
                    raise AssertionError(f"cli/sr did not launch K2: "
                                         f"{counts()}")
        worst = 0
        for name in names:
            a, b = (imageio.read_rgb(os.path.join(sr_dirs[d], name))
                    for d in ("cuda", "cpu"))
            if a.shape != (*LPSR_HW, 3) or b.shape != a.shape:
                raise AssertionError(f"cli/sr {name}: shapes {a.shape}, "
                                     f"{b.shape}")
            worst = max(worst, int(np.abs(a.astype(int) - b).max()))
        print(f"cli/sr on {LR_STRIPS}: {len(names)} PNGs of "
              f"{(*LPSR_HW, 3)}, card vs CPU max {worst} LSB (<= 1), K2 "
              f"launches {sr_launches}", flush=True)
        if worst > 1:
            raise AssertionError("cli/sr: the card's PNGs differ from the "
                                 "CPU's by more than 1 LSB")

        # 4. cli/run on the demo frame at the default 1280x1280 detector
        src = os.path.join(tmp, "frames")
        os.makedirs(src)
        demo = imageio.list_images(DEMO_FRAMES)[0]
        for i in range(RUN_FRAMES):
            shutil.copy(os.path.join(DEMO_FRAMES, demo),
                        os.path.join(src, f"f{i:03d}.png"))
        run_argv = ["--source", src, "--d-weights", CKPT_PLATE,
                    "--r-weights", CKPT_CHAR, "--sr-weights", CKPT_LPSR,
                    "--out", os.path.join(tmp, "run"), "--panel",
                    "--batch", "4"]
        counts_to_zero()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            printed = cli_run.main(run_argv)
        torch.cuda.synchronize()
        run_counts = counts()
        text = out.getvalue()
        print(text.splitlines()[0] + " ... " + text.splitlines()[-1],
              flush=True)
        if run_counts["yolo_front"] < 1 or run_counts["lpsr"] < 1:
            raise AssertionError(f"cli/run did not launch K1 and K2: "
                                 f"{run_counts}")
        written = sorted(os.listdir(os.path.join(tmp, "run")))
        if sum(f.startswith("frame_") for f in written) != RUN_FRAMES:
            raise AssertionError(f"cli/run wrote {written}")
        rec = cli_run.build_recognizer(cli_run.parse_args(run_argv))
        frame = imageio.read_rgb(os.path.join(DEMO_FRAMES, demo))
        want = rec.recognize(np.stack([frame] * 4))[0]

        def key(res):
            return [(p["class_id"], p["text"], p["text_sr"]) for p in res]

        if any(key(p) != key(want) for p in printed):
            raise AssertionError(f"cli/run printed {key(printed[0])}, "
                                 f"recognize() gives {key(want)}")
        fps = float(text.rsplit("last fps ", 1)[1].rstrip(")\n"))
        # where a batch of the CLI's time goes, each piece alone
        from lpr_tpu_torch.pipeline.annotate import annotate_frame

        path = os.path.join(DEMO_FRAMES, demo)
        read_ms = 1e3 * min(_wall(lambda: imageio.read_rgb(path))
                            for _ in range(3))
        write_ms = 1e3 * min(_wall(lambda: imageio.write_png(
            os.path.join(tmp, "w.png"), annotate_frame(frame, want)))
            for _ in range(3))
        step_ms = 1e3 * min(_wall(lambda: rec.recognize(
            np.stack([frame] * 4))) for _ in range(3))
        print(f"cli/run on {card}: {RUN_FRAMES} frames of "
              f"{frame.shape}, detector 1280x1280 bf16, batch 4: plates "
              f"{key(want)} equal to recognize(); {len(written)} PNGs "
              f"written; {fps} frames/s (the CLI's own, last batch: "
              f"reading, recognizing, annotating and writing); alone, best "
              f"of 3: read_rgb {read_ms:.1f} ms a frame, annotate + "
              f"write_png {write_ms:.1f} ms a frame, recognize() "
              f"{step_ms:.1f} ms a batch of 4; launches {run_counts}",
              flush=True)
        note["run"] = f"{fps} frames/s"

        # 5. cli/find_improvement on the real plates
        counts_to_zero()
        found = cli_fi.main(["--eval-folder", EVAL_FOLDERS[0], *weights,
                             "--out", os.path.join(tmp, "improved")])
        torch.cuda.synchronize()
        fi_counts = counts()
        if fi_counts["lpsr"] < 1:
            raise AssertionError(f"find_improvement did not launch K2: "
                                 f"{fi_counts}")
        print(f"cli/find_improvement on {EVAL_FOLDERS[0]}: {len(found)} "
              f"panels written ({found}), K2 launches {fi_counts['lpsr']}",
              flush=True)

        # 6. cli/serve as a process: one frame over HTTP, then SIGINT
        serve_argv = ["--d-weights", CKPT_PLATE, "--r-weights", CKPT_CHAR,
                      "--sr-weights", CKPT_LPSR, "--port", "0"]
        proc = subprocess.Popen(
            [sys.executable, "-m", "lpr_tpu_torch.cli.serve", *serve_argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout],
                         daemon=True).start()
        try:
            url = None
            t_end = time.perf_counter() + SERVE_TIMEOUT_S
            while url is None and time.perf_counter() < t_end:
                try:
                    line = lines.get(timeout=5)
                except queue.Empty:
                    if proc.poll() is not None:
                        break
                    continue
                print(f"cli/serve: {line.rstrip()}", flush=True)
                if line.startswith("serving on "):
                    url = line.split()[2]
            if url is None:
                raise AssertionError("cli/serve did not start")
            buf = io.BytesIO()
            np.save(buf, frame)
            req = urllib.request.Request(url + "/v2/models/pipeline/infer",
                                         data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
                served = json.loads(r.read())
            srec = cli_run.build_recognizer(cli_serve.parse_args(serve_argv))
            want = srec.recognize(np.stack([frame] * 8))[0]
            if key(served) != key(want):
                raise AssertionError(f"cli/serve answered {key(served)}, "
                                     f"recognize() gives {key(want)}")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"cli/serve exited {rc} on SIGINT")
            print(f"cli/serve: answer {key(served)} equal to recognize(); "
                  f"exited 0 on SIGINT", flush=True)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        note["serve"] = "ok"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return entry, note


def export_phase(card, counts_to_zero, counts):
    """Phase export: the reference's pickled-module .pt imported on the
    card (the plate detector through the recognizer and K1, the char OCR
    through load_char_detector), LPSR emitted as ONNX and loaded back
    (K2 bf16 and float32), the ONNX executor on the card and torch.export
    programs on the card; returns a note for the phase line."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lpr_tpu_torch import imageio
    from lpr_tpu_torch.kernels import lpsr as kl
    from lpr_tpu_torch.kernels import yolo_front as kf
    from lpr_tpu_torch.models import yolo as tyolo
    from lpr_tpu_torch.models.detector import load_char_detector
    from lpr_tpu_torch.models.lpsr import load_lpsr, lpsr_state
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer)
    from lpr_tpu_torch.tools.synth import synth_frames
    from lpr_tpu_torch.weights import (export_program, onnx_export,
                                       onnx_import, onnx_run)
    from lpr_tpu_torch.weights.checkpoint import load_state
    from tests.pt_fixture import write_yolo_pt

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return (a is None and b is None) or torch.equal(a, b)

    note = {}
    tmp = tempfile.mkdtemp(prefix="lpr_export_")
    try:
        t0 = time.perf_counter()
        # 1. plate_det640.npz as a YOLOv5 .pt (tests/pt_fixture.py), read by
        # load_yolo_torch on the card: K1's pack, K1's output and the
        # recognizer's eager step equal the npz detector's bit for bit.
        state, _ = load_state(CKPT_PLATE)
        pt = write_yolo_pt(os.path.join(tmp, "plate.pt"),
                           tyolo.yolov5_spec(nc=11), (8, 16, 32), state,
                           [f"p{i}" for i in range(11)])
        plate_pt = tyolo.load_yolo_torch(pt, device="cuda")[0]
        plate_npz = tyolo.load_plate_detector(CKPT_PLATE)
        rec = PlateRecognizer(
            plate_npz, tyolo.load_char_ocr_npz(CKPT_CHAR)[0],
            load_lpsr(CKPT_LPSR),
            PipelineConfig(det_hw=DET_HW, dtype=torch.bfloat16))
        frames = synth_frames(BATCH, FRAME_HW, SEED)
        pack_npz = rec._front
        want = rec.step_eager(frames)
        rec.replace_models(plate_model=plate_pt)
        if not same(dict(rec._front), dict(pack_npz)):
            raise AssertionError("K1's pack of the .pt detector differs")
        x = torch.rand((BATCH, *DET_HW, 3), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           SEED)).to(torch.bfloat16)
        # the step's own launches: K1 once, K2 once, nothing else
        counts_to_zero()
        got = rec.step_eager(frames)
        torch.cuda.synchronize()
        c = {k: v for k, v in counts().items() if v}
        if c != {"yolo_front": 1, "lpsr": 1}:
            raise AssertionError(f"the .pt detector's step launched {c}, "
                                 f"not K1 once and K2 once")
        if not same(got, want):
            raise AssertionError("the recognizer's step with the .pt "
                                 "detector differs from the npz's")
        counts_to_zero()
        k1 = [kf.yolo_front(x, p) for p in (rec._front, pack_npz)]
        torch.cuda.synchronize()
        if counts()["yolo_front"] != 2 or not torch.equal(*k1):
            raise AssertionError(f"K1 on the .pt detector's pack differs "
                                 f"(launches {counts()})")
        n_plates = int(want["plate_valid"].sum())
        print(f"export .pt plate detector: K1 pack and output, and the "
              f"eager step's outputs ({n_plates} plates in {BATCH} frames) "
              f"equal to the npz detector's bit for bit; the step's "
              f"launches {c} ({time.perf_counter() - t0:.2f} s)",
              flush=True)
        note["pt plate"] = "bit-equal"

        t0 = time.perf_counter()
        # 2. char_ocr_synth.npz as a char.pt through load_char_detector
        state, side = load_state(CKPT_CHAR)
        pt = write_yolo_pt(os.path.join(tmp, "char.pt"),
                           tyolo.char_ocr_spec(), (8,), state,
                           [f"c{i}" for i in range(36)],
                           anchors=side["__anchors__"])
        det_pt, det_npz = load_char_detector(pt), load_char_detector(
            CKPT_CHAR)
        folder = EVAL_FOLDERS[1]
        files = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
        n_chars = 0
        for f in files[:8]:
            crop = imageio.read_rgb(os.path.join(folder, f))
            a, b = det_pt.detect(crop), det_npz.detect(crop)
            if not (np.array_equal(a.boxes, b.boxes)
                    and np.array_equal(a.scores, b.scores)
                    and np.array_equal(a.classes, b.classes)):
                raise AssertionError(f"char .pt detections differ on {f}")
            n_chars += len(a)
        if n_chars < 1:
            raise AssertionError("the char detector found no characters")
        print(f"export .pt char OCR: load_char_detector's detections on 8 "
              f"crops of {folder} ({n_chars} characters) equal to the "
              f"npz's bit for bit ({time.perf_counter() - t0:.2f} s)",
              flush=True)
        note["pt char"] = "bit-equal"

        t0 = time.perf_counter()
        # 3. LPSR emitted as ONNX and loaded back on the card: K2 (float32,
        # then bf16) on it equal to K2 on the npz model bit for bit.
        onnx = os.path.join(tmp, "sr.onnx")
        onnx_export.export_lpsr_onnx(lpsr_state(CKPT_LPSR), onnx)
        sr_onnx, sr_npz = load_lpsr(onnx), load_lpsr(CKPT_LPSR)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for dt, n in ((torch.float32, 64), (torch.bfloat16, LPSR_N)):
            crops = torch.rand((n, *LPSR_HW, 3), device="cuda",
                               generator=gen).to(dt)
            packs = [kl.lpsr_pack(m.to(dt)) for m in (sr_onnx, sr_npz)]
            counts_to_zero()
            ys = [kl.lpsr_fused(crops, p) for p in packs]
            torch.cuda.synchronize()
            if counts()["lpsr"] != 2:
                raise AssertionError(f"K2 {dt}: launches {counts()}")
            if not torch.equal(*ys):
                raise AssertionError(f"K2 {dt} on the ONNX-loaded LPSR "
                                     f"differs from the npz's")
        print(f"export .onnx LPSR: K2 float32 (64 crops) and bf16 "
              f"({LPSR_N} crops) on it equal to K2 on the npz model bit "
              f"for bit ({time.perf_counter() - t0:.2f} s)", flush=True)
        note["onnx lpsr"] = "bit-equal"

        t0 = time.perf_counter()
        # 4. the ONNX executor on the card against LPSR.forward (float32,
        # TF32 off)
        sr32 = load_lpsr(CKPT_LPSR)
        x = torch.rand((LPSR_N, 3, *LPSR_HW), device="cuda", generator=gen)
        with torch.inference_mode():
            y = onnx_run.run_onnx(onnx_import.load_onnx(onnx),
                                  {"input_image": x})[0]
            ref = sr32(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)
        err = (y - ref).abs().max().item()
        print(f"export run_onnx on {y.device}: max_abs_err {err} against "
              f"LPSR.forward (< {ONNX_RUN_TOL}, float32) "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        if y.device.type != "cuda" or not err < ONNX_RUN_TOL:
            raise AssertionError("run_onnx on the card disagrees")
        note["run_onnx err"] = err

        t0 = time.perf_counter()
        # 5. torch.export programs on the card, against the forwards
        p2 = os.path.join(tmp, "sr.pt2")
        export_program.export_lpsr(sr32, p2, batch=LPSR_N)
        xh = x.permute(0, 2, 3, 1).contiguous()
        with torch.inference_mode():
            errs = {"lpsr": (export_program.load_fn(p2)(xh) - sr32(xh))
                    .abs().max().item()}
        plate32 = tyolo.load_yolo_torch(
            os.path.join(tmp, "plate.pt"), device="cuda")[0]
        p3 = os.path.join(tmp, "plate.pt2")
        export_program.export_detector(plate32, p3, batch=1, hw=DET_HW)
        xd = torch.rand((1, *DET_HW, 3), device="cuda", generator=gen)
        with torch.inference_mode():
            got = export_program.load_fn(p3)(xd)
            ref = plate32(xd, decode=True)[0]
        errs["detector"] = ((got - ref).abs() / (1 + ref.abs())).max().item()
        print(f"export .pt2 on the card: LPSR ({LPSR_N} crops) max_abs_err "
              f"{errs['lpsr']}, plate detector (1x{DET_HW[0]}x{DET_HW[1]}, "
              f"decoded) max err / (1 + |pred|) {errs['detector']} against "
              f"the forwards (< {PT2_TOL}, float32) "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        if not max(errs.values()) < PT2_TOL:
            raise AssertionError(f".pt2 programs disagree: {errs}")
        note["pt2 err"] = errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return note


_T0 = time.perf_counter()


def phase(name: str, t_start: float, note: str = "") -> None:
    print(f"phase {name}: ok {time.perf_counter() - t_start:.2f} s "
          f"(total {time.perf_counter() - _T0:.2f} s){note}", flush=True)


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
    from lpr_tpu_torch.kernels import conv_int8 as ki
    from lpr_tpu_torch.kernels import lpsr as kl
    from lpr_tpu_torch.kernels import yolo_front as kf
    from lpr_tpu_torch.kernels import yolo_mid as km
    from lpr_tpu_torch.tools import _timing, bench_sr_convs

    t = time.perf_counter()
    libs = _build.build()
    for name, lib in libs.items():
        if name != "conv_int8":    # its 54 kernels: one line each below
            for line in lib.ptxas_log:
                print(f"nvcc[{name}]: {line}", flush=True)
    if sorted(libs) != ["conv_int8", "lpsr", "yolo_front", "yolo_mid"]:
        raise AssertionError(f"built {sorted(libs)}")
    smem = {n: getattr(libs[n].cdll, f"lpr_{n}_smem_bytes")() for n in libs}
    # The tensor cores in K2: HMMA instructions of lpsr_kernel<bf16> (with
    # the stage functions it calls) and of lpsr_kernel<float>.
    hmma = _build.sass_counts(libs["lpsr"].path, "HMMA")
    for fn, c in sorted(hmma.items()):
        print(f"cuobjdump -sass lpsr: {c} HMMA in {fn}", flush=True)
    k2_hmma = {dt: sum(c for fn, c in hmma.items() if tag in fn)
               for dt, tag in (("bf16", "__nv_bfloat16"), ("float", "IfE"))}
    print(f"K2 HMMA instructions: lpsr_kernel<bf16> {k2_hmma['bf16']}, "
          f"lpsr_kernel<float> {k2_hmma['float']}", flush=True)
    if min(k2_hmma.values()) < 1:
        raise AssertionError(f"no HMMA in an instance of lpsr_kernel: "
                             f"{k2_hmma}")
    # K1's instances front_kernel<STAGE, bf16> (mangled
    # front_kernelILi<STAGE>E13__nv_bfloat16) and its uint8 instance
    # front_kernel<FULL, uint8_t> (front_kernelILi3EhE); the dma one
    # stages its input and multiplies nothing.
    hmma = _build.sass_counts(libs["yolo_front"].path, "HMMA")
    k1_hmma = {st: sum(c for fn, c in hmma.items()
                       if f"front_kernelILi{i}E13__nv_bfloat16" in fn)
               for i, st in enumerate(kf.STAGES) if st != "dma"}
    k1_hmma["full, uint8"] = sum(c for fn, c in hmma.items()
                                 if "front_kernelILi3EhE" in fn)
    print(f"K1 HMMA instructions: " + ", ".join(
        f"front_kernel<{st.upper()}> {c}" for st, c in k1_hmma.items()),
        flush=True)
    if k1_hmma["full"] < 1:
        raise AssertionError("no HMMA in front_kernel<FULL, bf16>")
    if k1_hmma["full, uint8"] < 1:
        raise AssertionError("no HMMA in front_kernel<FULL, uint8_t>")
    log = libs["yolo_front"].ptxas_log
    at = [i for i, ln in enumerate(log) if "front_kernelILi3EhE" in ln]
    k1u8_nvcc = [ln for ln in log[at[0]:at[0] + 4]
                 if "Used" in ln or "spill" in ln] if at else []
    print(f"K1 front_kernel<FULL, uint8_t>: nvcc "
          f"{'; '.join(k1u8_nvcc) or 'not reported (library already built)'}",
          flush=True)
    # K3's one kernel, mid_kernel: its tensor-core mma and nvcc's report.
    k3_hmma = sum(c for fn, c in _build.sass_counts(
        libs["yolo_mid"].path, "HMMA").items() if "mid_kernel" in fn)
    log = libs["yolo_mid"].ptxas_log
    at = [i for i, ln in enumerate(log) if "mid_kernel" in ln]
    k3_nvcc = [ln for ln in log[at[0]:at[0] + 4]
               if "Used" in ln or "spill" in ln] if at else []
    print(f"K3 mid_kernel: {k3_hmma} HMMA instructions; nvcc "
          f"{'; '.join(k3_nvcc) or 'not reported (library already built)'}",
          flush=True)
    if k3_hmma < 1:
        raise AssertionError("no HMMA in mid_kernel")
    # I2's instances conv_int8_kernel<T, BN, ACT, RES, AMAX>: the
    # warpgroup MMA (IGMMA: wgmma.mma_async on s8, as cuobjdump -sass
    # names it) in every one; nvcc's registers and spills for each of I1's
    # and I2's kernels.
    i2_igmma = {fn: c for fn, c in
                _build.sass_counts(libs["conv_int8"].path, "IGMMA").items()
                if "conv_int8_kernel" in fn}
    log = libs["conv_int8"].ptxas_log
    for i, ln in enumerate(log):
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
            tag = fn.split("conv_int8_kernel", 1)[-1][:28] if (
                "conv_int8_kernel" in fn) else fn.split("_GLOBAL__N_", 1)[-1][-40:]
            info = "; ".join(x.split(":", 1)[-1].strip() for x in
                             log[i + 1:i + 4] if "Used" in x or "spill" in x)
            print(f"nvcc[conv_int8] {tag}: {info}", flush=True)
    for ln in log:
        if "wgmma" in ln:
            print(f"nvcc[conv_int8]: {ln}", flush=True)
    print(f"I2 conv_int8_kernel: {len(i2_igmma)} instances, IGMMA "
          f"instructions per instance {min(i2_igmma.values(), default=0)}-"
          f"{max(i2_igmma.values(), default=0)}; I1/I2 nvcc "
          f"{'reported above' if log else 'not reported (library already built)'}",
          flush=True)
    if len(i2_igmma) != I2_INSTANCES or min(i2_igmma.values()) < 1:
        raise AssertionError(f"an instance of conv_int8_kernel without "
                             f"IGMMA, or not {I2_INSTANCES} instances: "
                             f"{i2_igmma}")
    # The host libraries (g++): the letterbox of the packed input always;
    # the image decode only where g++ finds libjpeg's and libpng's headers
    # (without them it cannot build, and its calls are not driven).
    decode_missing = _build.missing_headers("host_decode")
    host_names = ["host_letterbox"] + (["host_decode"] if not decode_missing
                                       else [])
    for n in host_names:
        print(f"g++[{n}]: {' '.join(_build.host_command(n, _build._target(n, '.cc')))}",
              flush=True)
    host_libs = _build.build_host(host_names)
    if decode_missing:
        print(f"host_decode: not built, and the decode calls (submit_path, "
              f"submit_paths, submit_bytes, bench_serving --files) are not "
              f"driven: g++ finds no {' or '.join(decode_missing)} on this "
              f"machine (libjpeg's and libpng's development files are not "
              f"installed)", flush=True)
    phase("build", t, f"; {sorted(libs)} + {sorted(host_libs)}; dynamic "
          f"smem per block {smem} B")

    def counts_to_zero():
        kf.yolo_front.launches = 0
        kf.yolo_front.launches_u8 = 0
        kl.lpsr_fused.launches = 0
        km.yolo_mid.launches = 0
        kf.front_stage.launches = dict.fromkeys(kf.STAGES, 0)
        ki.act_amax.launches = 0
        ki.quantize_act.launches = 0
        ki.conv_int8.launches = 0

    def counts():
        return {"yolo_front": kf.yolo_front.launches,
                "yolo_front_u8": kf.yolo_front.launches_u8,
                "lpsr": kl.lpsr_fused.launches,
                "yolo_mid": km.yolo_mid.launches,
                "act_amax": ki.act_amax.launches,
                "quantize_act": ki.quantize_act.launches,
                "conv_int8": ki.conv_int8.launches}

    def timed(kernel, plain, iters, graphed=False):
        """(kernel ms, plain ms, runs) over turns plain, kernel, kernel,
        plain; each the best of its two runs.  ``graphed``: each run a CUDA
        graph of ``iters`` calls (_timing.graph_ms), for kernels shorter
        than their launch's host cost."""
        time_of = _timing.graph_ms if graphed else _timing.event_ms
        runs = [time_of(f, iters) for f in (plain, kernel, kernel, plain)]
        return min(runs[1:3]), min(runs[0], runs[3]), runs

    # ---- 3. kernels -----------------------------------------------------
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector)

    t = time.perf_counter()
    kernels = []
    iters = 20

    # K1 — the detector front, on frames: the main path's slice of two
    # frames first, then the square detector, the CPU tests' frame and the
    # least whole tile.
    plate = load_plate_detector(CKPT_PLATE).to(torch.bfloat16)
    packed = kf.front_pack(plate)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_max_err = None
    k1_outs = {}          # K1's outputs, K3's further inputs
    for shape in [(2, *DET_HW)] + K1_SHAPES:
        xs = torch.rand((*shape, 3), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        got = kf.yolo_front(xs, packed)
        k1_outs[shape] = got
        ref = kf.front_plain(xs, packed)
        torch.cuda.synchronize()
        max_err, ratio, mean_int = kf.front_errors(got, ref)
        diff = (got.float() - ref.float()).abs()
        n_ulp = int((diff > 0).sum().item())
        print(f"K1 yolo_front vs front_plain {(*shape, 3)} bf16: "
              f"max_abs_err {max_err}, max err/(abs {kf.TOL_ABS} + rel "
              f"{kf.TOL_REL}) {ratio} (< 1), interior mean {mean_int} "
              f"(< {kf.TOL_INTERIOR_MEAN}), {n_ulp} of {got.numel()} "
              f"differ, max |plain| {ref.float().abs().max().item()}, "
              f"worst at "
              f"{[int(i) for i in torch.nonzero(diff == diff.max())[0]]}",
              flush=True)
        if not (ratio < 1.0 and mean_int < kf.TOL_INTERIOR_MEAN):
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape}")
        if k1_max_err is None:
            k1_max_err = max_err         # the main path's shape
    # A pack whose weights bf16 would round is refused, and nothing runs.
    packed32 = kf.front_pack(load_plate_detector(CKPT_PLATE))
    launches_before = kf.yolo_front.launches
    try:
        kf.yolo_front(xs, packed32)
    except ValueError as e:
        print(f"K1 with a pack that is not bf16-exact: ValueError ({e})",
              flush=True)
    else:
        raise AssertionError("K1 took a pack that is not bf16-exact")
    if kf.yolo_front.launches != launches_before:
        raise AssertionError("K1 counted a refused launch")
    x8 = torch.rand((BATCH, *DET_HW, 3), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    k_ms, plain_ms, runs = timed(lambda: kf.yolo_front(x8, packed),
                                 lambda: kf.front_plain(x8, packed), iters)
    # The library yardstick: the model's own layers 0-2 in bf16 through
    # cuDNN (three convolutions and the C3's seven layers; no single
    # PyTorch call computes them).
    with torch.inference_mode():
        k1_lib_ms = _timing.event_ms(
            lambda: plate.forward_from(x8, 0, 3), iters)
    bound_ms, bound_by = _timing.bound_ms(kf.front_work(BATCH, *DET_HW))
    print(f"K1 timing at ({BATCH}, {DET_HW[0]}, {DET_HW[1]}, 3) on {card}: "
          f"kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms (runs plain, "
          f"kernel, kernel, plain {runs}), library (layers 0-2 bf16, "
          f"cuDNN) {k1_lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {kf.front_work(BATCH, *DET_HW)} FLOP, B)",
          flush=True)
    kernels.append({
        "name": "yolo_front", "route": "cuda",
        "source": "lpr_tpu_torch/csrc/yolo_front.cu",
        "replaces": "lpr_tpu/ops/pallas/yolo_front.py:461",
        "launches": None, "max_abs_err": k1_max_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": k1_lib_ms,
    })

    # K1's uint8 instance (the TPU kernel's is_u8 mode) — raw letterboxed
    # bytes with 1/255 folded into the stem — at the main path's shape and
    # K1's further shapes, against its plain version on the same bytes.
    packed_u8 = kf.front_pack(plate, input_scale=1.0 / 255.0)
    k1u8_max_err = None
    for shape in [(BATCH, *DET_HW), (2, *DET_HW)] + K1_SHAPES:
        xs = torch.randint(0, 256, (*shape, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
        got = kf.yolo_front(xs, packed_u8)
        ref = kf.front_plain(xs, packed_u8)
        torch.cuda.synchronize()
        max_err, ratio, mean_int = kf.front_errors(got, ref)
        print(f"K1 yolo_front vs front_plain {(*shape, 3)} uint8: "
              f"max_abs_err {max_err}, max err/(abs {kf.TOL_ABS} + rel "
              f"{kf.TOL_REL}) {ratio} (< 1), interior mean {mean_int} "
              f"(< {kf.TOL_INTERIOR_MEAN}), max |plain| "
              f"{ref.float().abs().max().item()}", flush=True)
        if not (ratio < 1.0 and mean_int < kf.TOL_INTERIOR_MEAN):
            raise AssertionError(f"K1 uint8 disagrees with its plain version "
                                 f"at {shape}")
        if k1u8_max_err is None:
            k1u8_max_err = max_err       # the main path's shape
    x8u = torch.randint(0, 256, (BATCH, *DET_HW, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    k_ms, plain_ms, runs = timed(lambda: kf.yolo_front(x8u, packed_u8),
                                 lambda: kf.front_plain(x8u, packed_u8),
                                 iters)
    # The library yardstick: the model's layers 0-2 in bf16 through cuDNN
    # on the same bytes, cast and scaled: bf16(u8) / 255.
    with torch.inference_mode():
        lib_ms = _timing.event_ms(lambda: plate.forward_from(
            x8u.to(torch.bfloat16) / 255.0, 0, 3), iters)
    work = kf.front_work(BATCH, *DET_HW, in_bytes=1)
    bound_ms, bound_by = _timing.bound_ms(work)
    print(f"K1 uint8 timing at ({BATCH}, {DET_HW[0]}, {DET_HW[1]}, 3) on "
          f"{card}: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms (runs "
          f"{runs}), library (bf16(u8)/255, layers 0-2 bf16, cuDNN) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {work} "
          f"FLOP, B)", flush=True)
    kernels.append({
        "name": "yolo_front_u8", "route": "cuda",
        "source": "lpr_tpu_torch/csrc/yolo_front.cu",
        "replaces": "lpr_tpu/ops/pallas/yolo_front.py:461",
        "launches": None, "max_abs_err": k1u8_max_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms,
    })

    # K2 — the LPSR stage, on the main path's 24 plate crops (bf16 and
    # float32), then in both at the shapes where a block owns 0-1 rows of
    # the quarter grid, M is not a multiple of 16, or a block's rows (48)
    # or the columns (400) split into slabs.
    lpsr_bf16 = load_lpsr(CKPT_LPSR).to(torch.bfloat16)
    lpsr_packed = kl.lpsr_pack(lpsr_bf16)
    lpsr_packed32 = kl.lpsr_pack(load_lpsr(CKPT_LPSR))
    crops = torch.rand((LPSR_N, *LPSR_HW, 3), generator=gen, device="cuda"
                       ).to(torch.bfloat16)
    k2_max_err = None
    for shape, dt in [((LPSR_N, *LPSR_HW), torch.bfloat16),
                      ((LPSR_N, *LPSR_HW), torch.float32)] + [
                          (s, dt) for s in K2_SHAPES
                          for dt in (torch.bfloat16, torch.float32)]:
        x = (crops if shape == (LPSR_N, *LPSR_HW) else torch.rand(
            (*shape, 3), generator=gen, device="cuda")).to(dt)
        pk = lpsr_packed if dt == torch.bfloat16 else lpsr_packed32
        got = kl.lpsr_fused(x, pk)
        ref = kl.lpsr_plain(x, pk)
        torch.cuda.synchronize()
        max_err, mean_err = kl.lpsr_errors(got, ref)
        tol_max, tol_mean = kl.TOL_MAX[dt], kl.TOL_MEAN[dt]
        name = str(dt).replace("torch.", "")
        print(f"K2 lpsr_fused vs lpsr_plain {(*shape, 3)} {name}: "
              f"max_abs_err {max_err} (< {tol_max}), mean {mean_err} "
              f"(< {tol_mean}), finite {bool(torch.isfinite(got).all())}",
              flush=True)
        if not (max_err < tol_max and mean_err < tol_mean
                and torch.isfinite(got).all()):
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"{shape} {name}")
        if k2_max_err is None:
            k2_max_err = max_err         # the main path's shape, bf16
    k_ms, plain_ms, runs = timed(lambda: kl.lpsr_fused(crops, lpsr_packed),
                                 lambda: kl.lpsr_plain(crops, lpsr_packed),
                                 iters)
    # The library yardstick: LPSR.forward in bf16 on the same crops,
    # composed of many cuDNN and elementwise calls (no single PyTorch call
    # computes the LPSR forward).
    with torch.inference_mode():
        lib_ms = bench_sr_convs.lpsr_forward_ms(lpsr_bf16, crops, iters)
    work = kl.lpsr_work(LPSR_N, *LPSR_HW)
    bound_ms, bound_by = _timing.bound_ms(work)
    print(f"K2 timing at ({LPSR_N}, {LPSR_HW[0]}, {LPSR_HW[1]}, 3) bf16 on "
          f"{card}: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms (runs "
          f"{runs}), library (composed LPSR.forward bf16) {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}; {work} FLOP, B)",
          flush=True)
    kernels.append({
        "name": "lpsr", "route": "cuda",
        "source": "lpr_tpu_torch/csrc/lpsr.cu",
        "replaces": "lpr_tpu/ops/pallas/lpsr_kernel.py:235",
        "launches": None, "max_abs_err": k2_max_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms,
    })

    # K3 — detector layers 3-4, on K1's real output for 8 frames (the main
    # path's shape), then on K1's output for the further frames and on
    # random front grids, one with a ragged tile in both axes.
    mid_packed = km.mid_pack(plate)
    y8 = kf.yolo_front(x8, packed)
    k3_max_err = None
    k3_inputs = [("K1's output", y8)] + [
        ("K1's output", k1_outs[s]) for s in K3_FRONT_SHAPES] + [
        ("random", torch.rand(s, generator=gen, device="cuda"
                              ).to(torch.bfloat16)) for s in K3_RANDOM_SHAPES]
    for label, ys in k3_inputs:
        got = km.yolo_mid(ys, mid_packed)
        ref = km.mid_plain(ys, mid_packed)
        torch.cuda.synchronize()
        max_err, ratio, mean_int = km.mid_errors(got, ref)
        diff = (got.float() - ref.float()).abs()
        print(f"K3 yolo_mid vs mid_plain on {label} {tuple(ys.shape)} bf16: "
              f"max_abs_err {max_err}, max err/(abs {km.TOL_ABS} + rel "
              f"{km.TOL_REL}) {ratio} (< 1), interior mean {mean_int} "
              f"(< {km.TOL_INTERIOR_MEAN}), {int((diff > 0).sum().item())} "
              f"of {got.numel()} differ, max |plain| "
              f"{ref.float().abs().max().item()}, finite "
              f"{bool(torch.isfinite(got.float()).all())}", flush=True)
        if not (ratio < 1.0 and mean_int < km.TOL_INTERIOR_MEAN
                and torch.isfinite(got.float()).all()):
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"{tuple(ys.shape)}")
        if k3_max_err is None:
            k3_max_err = max_err         # the main path's shape
    # A pack whose weights bf16 would round is refused, and nothing runs.
    mid_packed32 = km.mid_pack(load_plate_detector(CKPT_PLATE))
    launches_before = km.yolo_mid.launches
    try:
        km.yolo_mid(y8, mid_packed32)
    except ValueError as e:
        print(f"K3 with a pack that is not bf16-exact: ValueError ({e})",
              flush=True)
    else:
        raise AssertionError("K3 took a pack that is not bf16-exact")
    if km.yolo_mid.launches != launches_before:
        raise AssertionError("K3 counted a refused launch")
    k_ms, plain_ms, runs = timed(lambda: km.yolo_mid(y8, mid_packed),
                                 lambda: km.mid_plain(y8, mid_packed), iters)
    # The library yardstick: the model's own layers 3-4 in bf16 through
    # cuDNN (a convolution and the C3's nine layers; no single PyTorch
    # call computes them).
    with torch.inference_mode():
        k3_lib_ms = _timing.event_ms(
            lambda: plate.forward_from(y8, 3, 5), iters)
    work = km.mid_work(BATCH, *y8.shape[1:3])
    bound_ms, bound_by = _timing.bound_ms(work)
    print(f"K3 timing at {tuple(y8.shape)} on {card}: kernel {k_ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms (runs {runs}), library (layers 3-4 "
          f"bf16, cuDNN) {k3_lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {work} FLOP, B)", flush=True)
    kernels.append({
        "name": "yolo_mid", "route": "cuda",
        "source": "lpr_tpu_torch/csrc/yolo_mid.cu",
        "replaces": "lpr_tpu/ops/pallas/yolo_mid.py:273",
        "launches": None, "max_abs_err": k3_max_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": k3_lib_ms,
    })
    phase("kernels", t)

    # ---- 4. probe -------------------------------------------------------
    from lpr_tpu_torch.tools import probe_front_stages

    t = time.perf_counter()
    # K4's path: the probe tool times the four variants on K1's input.
    counts_to_zero()
    probe_ms = probe_front_stages.probe(x8, packed, iters, rounds=1)
    torch.cuda.synchronize()
    probe_counts = dict(kf.front_stage.launches)
    if min(probe_counts.values()) < 1:
        raise AssertionError(f"the probe did not launch every K4 variant: "
                             f"{probe_counts}")
    for line in probe_front_stages.report(probe_ms, BATCH, *DET_HW):
        print(f"probe on {card}: {line}", flush=True)
    # Each variant against its plain version on the same frames.
    for stage in kf.STAGES:
        got = kf.front_stage(x8, packed, stage)
        ref = kf.front_stage_plain(x8, packed, stage)
        torch.cuda.synchronize()
        max_err, ratio, mean_int = kf.front_errors(got, ref)
        if stage == "dma":
            ok = torch.equal(got, ref)
            rule = "bit for bit (a copy)"
        else:
            ok = ratio < 1.0 and mean_int < kf.TOL_INTERIOR_MEAN
            rule = (f"max err/(abs {kf.TOL_ABS} + rel {kf.TOL_REL}) {ratio} "
                    f"(< 1), interior mean {mean_int} "
                    f"(< {kf.TOL_INTERIOR_MEAN})")
        if stage == "full":
            ok = ok and torch.equal(got, y8)
            rule += "; bit for bit K1's output"
        print(f"K4 front_stage[{stage}] vs front_stage_plain "
              f"{tuple(x8.shape)} bf16: max_abs_err {max_err}; {rule}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise AssertionError(f"K4 {stage} disagrees with its plain "
                                 f"version")
        k_ms, plain_ms, runs = timed(
            lambda: kf.front_stage(x8, packed, stage),
            lambda: kf.front_stage_plain(x8, packed, stage), iters)
        # The model's own layers up to the same stage in bf16 (cuDNN).
        lib_ms, stop = None, kf.STAGES.index(stage)
        if stop:
            with torch.inference_mode():
                lib_ms = _timing.event_ms(
                    lambda: plate.forward_from(x8, 0, stop), iters)
        work = kf.front_stage_work(stage, BATCH, *DET_HW)
        bound_ms, bound_by = _timing.bound_ms(work)
        print(f"K4 {stage} timing at {tuple(x8.shape)} on {card}: kernel "
              f"{k_ms:.4f} ms, plain {plain_ms:.4f} ms (runs {runs}), "
              f"library (layers [0, {stop}) bf16, cuDNN) {lib_ms}, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {work} FLOP, B)", flush=True)
        kernels.append({
            "name": f"yolo_front_stage[{stage}]", "route": "cuda",
            "source": "lpr_tpu_torch/csrc/yolo_front.cu",
            "replaces": "tools/probe_front_stages.py:53",
            "launches": probe_counts[stage], "max_abs_err": max_err,
            "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
        })
    print("kernels: " + ", ".join(
        f"{k['name']} ({k['route']}, {k['source']}, replaces "
        f"{k['replaces']})" for k in kernels), flush=True)
    phase("probe", t, f"; launches {probe_counts}")

    # ---- 5. int8 --------------------------------------------------------
    import collections

    import torch.nn.functional as F

    from lpr_tpu_torch.models.yolo import quantize_yolo, quantized_convs
    from lpr_tpu_torch.ops.image import letterbox
    from lpr_tpu_torch.ops.nn import _resolve_padding
    from lpr_tpu_torch.tools.synth import synth_frames

    t = time.perf_counter()
    # The int8 detector as int8_detector builds it: quantized from the
    # float32 weights, then cast to bf16; K1 runs layers 0-2 from the float
    # weights.  One forward on the slice's letterboxed frames records, at
    # every int8 conv, its real input, residual and plan (kept once per
    # distinct (weight shape, input shape, stride, padding, residual, max)
    # with how often the step runs it), and every I1 call the step makes;
    # each quantize that reads carried slots must find max(slots) equal to
    # the plain max|x| of its input, bit for bit.
    plate8 = quantize_yolo(load_plate_detector(CKPT_PLATE)).to(torch.bfloat16)
    front8 = kf.front_pack(plate8)
    frames = synth_frames(BATCH, FRAME_HW, SEED)
    with torch.inference_mode():
        lb8 = letterbox(torch.as_tensor(frames, device="cuda").to(
            torch.bfloat16) / 255.0, DET_HW, fill=0.0)[0].contiguous()
    seen = {}
    i1_calls = collections.Counter()     # ("max" | n slots, shape) -> calls
    carried = []

    def keep_input(conv, args, kwargs):
        x = getattr(args[0], "x", args[0])
        res = kwargs.get("residual")
        c = conv.conv
        key = (tuple(conv.w_q.shape), tuple(x.shape), c.stride,
               _resolve_padding(c.padding, *conv.w_q.shape[:2]),
               res is not None, conv.out_slot is not None)
        if key not in seen:
            seen[key] = [x.clone(), None if res is None else res.clone(), 0,
                         conv]
        seen[key][2] += 1

    real_quantize, real_amax = ki.quantize_act, ki.act_amax

    def quantize_rec(x, slots=None):
        out = real_quantize(x, slots)
        i1_calls[(len(slots or [None]), tuple(x.shape))] += 1
        if slots is not None:
            carried.append(torch.equal(torch.cat(slots).amax(),
                                       ki.act_amax_plain(x)))
        return out

    def amax_rec(x, slot):
        i1_calls[("max", tuple(x.shape))] += 1
        return real_amax(x, slot)

    # the wrappers count their launches on their module-level names, which
    # the recorders stand in for during this forward
    quantize_rec.launches = amax_rec.launches = 0

    hooks = [m.register_forward_pre_hook(keep_input, with_kwargs=True)
             for m in quantized_convs(plate8).values()]
    ki.quantize_act, ki.act_amax = quantize_rec, amax_rec
    try:
        with torch.inference_mode():
            plate8(lb8, front=front8)
        torch.cuda.synchronize()
    finally:
        ki.quantize_act, ki.act_amax = real_quantize, real_amax
        for h in hooks:
            h.remove()
    n_run = sum(v[2] for v in seen.values())
    n_max = sum(n for k, n in i1_calls.items() if k[0] == "max")
    n_quant = sum(n for k, n in i1_calls.items() if k[0] != "max")
    shapes = {k[:4] for k in seen}
    print(f"int8 detector at ({BATCH}, {DET_HW[0]}, {DET_HW[1]}): "
          f"{len(quantized_convs(plate8))} quantized convs, {n_run} run "
          f"after K1 at {len(shapes)} distinct (weight, input) shapes "
          f"({len(seen)} with the residual and max flags); I1 a step: "
          f"{n_max} max pass(es), {n_quant} quantizes; the carried max "
          f"equal to the plain max at {sum(carried)} of {len(carried)} "
          f"quantizes that read slots", flush=True)
    if not all(carried) or (n_max, n_quant, n_run) != (1, 43, 50):
        raise AssertionError(f"the int8 detector's plan: {n_max} max "
                             f"passes, {n_quant} quantizes, {n_run} convs, "
                             f"carried max equal {carried}")
    # Every instance at every shape, bit for bit against the plain
    # versions on the same real input: I1's max pass, its quantize from
    # 1-4 slots (channel slices), I2's sums and its 24 epilogue instances
    # (bf16 and float32 x act x residual x max; the residual the step's
    # own where it has one, else a random tensor of the output's shape).
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checked = 0
    # the largest |kernel - plain| of each kernel over these checks (0 when
    # the checks above hold; printed on the kernels line)
    err = dict.fromkeys(("amax", "i1", "i2"), 0.0)

    def gap(a, b):
        return float((a.double() - b.double()).abs().max())
    for w_shape, x_shape, stride, pad in sorted(shapes):
        x, res, _, conv = next(v for k, v in seen.items()
                               if k[:4] == (w_shape, x_shape, stride, pad))
        ws = conv.w_s_bits.view(torch.float32)
        b = None if conv.b_bits is None else conv.b_bits.view(torch.float32)
        kw = dict(stride=(stride, stride), padding=pad)
        with torch.inference_mode():
            pxq, psx = ki.quantize_act_plain(x)
            for n in (1, 2, 3, 4):
                parts = [p.contiguous() for p in torch.tensor_split(
                    x, n, dim=-1)]
                slots = torch.zeros(n, device="cuda")
                for i, p in enumerate(parts):
                    ki.act_amax(p, slots[i:i + 1])
                xq, sx = ki.quantize_act(x, [slots[i:i + 1]
                                             for i in range(n)])
                torch.cuda.synchronize()
                err["i1"] = max(err["i1"], gap(xq, pxq), gap(sx, psx))
                err["amax"] = max([err["amax"]] + [
                    gap(slots[i], ki.act_amax_plain(p))
                    for i, p in enumerate(parts)])
                if not (torch.equal(xq, pxq) and torch.equal(sx, psx)
                        and all(torch.equal(slots[i], ki.act_amax_plain(p))
                                for i, p in enumerate(parts))):
                    raise AssertionError(f"I1 with {n} slots differs from "
                                         f"its plain version at {x_shape}")
            acc = ki.conv_int8(xq, sx, conv.w_q, ws, b, packed=conv.w_pack,
                               raw=True, **kw)
            acc_ref = ki.conv_int8_plain(xq, sx, conv.w_q, ws, b, raw=True,
                                         **kw)
            err["i2"] = max(err["i2"], gap(acc, acc_ref))
            if not torch.equal(acc, acc_ref):
                raise AssertionError(f"I2's int32 sums differ at {w_shape} "
                                     f"on {x_shape}")
            for dt in (torch.bfloat16, torch.float32):
                r = (res if res is not None else torch.randn(
                    acc.shape, generator=gen, device="cuda")).to(dt)
                for act in ki.ACTS:
                    for rr in (None, r):
                        ref = ki.conv_int8_plain(xq, sx, conv.w_q, ws, b,
                                                 out_dtype=dt, act=act,
                                                 residual=rr, **kw)
                        for with_max in (False, True):
                            slot = (torch.zeros(1, device="cuda")
                                    if with_max else None)
                            y = ki.conv_int8(xq, sx, conv.w_q, ws, b,
                                             packed=conv.w_pack, out_dtype=dt,
                                             act=act, residual=rr, amax=slot,
                                             **kw)
                            torch.cuda.synchronize()
                            err["i2"] = max(err["i2"], gap(y, ref))
                            if with_max:
                                err["i2"] = max(err["i2"], gap(
                                    slot, ki.act_amax_plain(ref)))
                            ok = torch.equal(y, ref) and (
                                not with_max or torch.equal(
                                    slot, ki.act_amax_plain(ref).reshape(1)))
                            if not ok:
                                raise AssertionError(
                                    f"I2 differs from its plain version at "
                                    f"{w_shape} on {x_shape}: {dt}, {act}, "
                                    f"residual {rr is not None}, max "
                                    f"{with_max}")
                            checked += 1
    print(f"int8: at the {len(shapes)} shapes, I1's max pass and its "
          f"quantize from 1-4 slots, I2's int32 sums and its {checked} "
          f"epilogue launches (bf16 and float32 x none/silu/leaky x "
          f"residual x max) equal to the plain versions bit for bit",
          flush=True)
    # Times: each conv as the step runs it (bf16, its act, its residual,
    # its max) and each I1 call of the step, in turns with the plain
    # versions, beside the bounds and the yardsticks, each a CUDA graph of
    # repeated calls (device time: the kernels are shorter than a launch's
    # host cost); summed over the step.
    tot = dict.fromkeys(("amax", "amax_plain", "amax_bound", "amax_lib", "i1",
                         "i1_plain", "i1_bound", "i2", "i2_plain", "i2_bound",
                         "int_mm", "cudnn"), 0.0)
    int_mm_ok = True
    i2_ops_time = 0.0
    it = 10
    for (w_shape, x_shape, stride, pad, has_res, has_max), (
            x, res, n, conv) in sorted(seen.items(), key=lambda kv: kv[0]):
        kh, kw_, cin, cout = w_shape
        ws = conv.w_s_bits.view(torch.float32)
        b = None if conv.b_bits is None else conv.b_bits.view(torch.float32)
        kw = dict(stride=(stride, stride), padding=pad)
        slot = torch.zeros(1, device="cuda") if has_max else None
        with torch.inference_mode():
            xq, sx = ki.quantize_act_plain(x)

            def plain():
                y = ki.conv_int8_plain(xq, sx, conv.w_q, ws, b,
                                       out_dtype=x.dtype, act=conv.act,
                                       residual=res, **kw)
                return ki.act_amax_plain(y) if has_max else y

            c_ms, c_plain, _ = timed(
                lambda: ki.conv_int8(xq, sx, conv.w_q, ws, b,
                                     packed=conv.w_pack, out_dtype=x.dtype,
                                     act=conv.act, residual=res, amax=slot,
                                     **kw), plain, it, graphed=True)
            # yardsticks: torch._int_mm over the im2col of the codes (the
            # same int32 sums), and cuDNN's bf16 conv of the same shape
            cols = F.unfold(xq[..., :cin].permute(0, 3, 1, 2).to(
                torch.float16), (kh, kw_), padding=pad, stride=stride)
            a_mat = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(
                torch.int8).contiguous()
            b_mat = conv.w_q.permute(2, 0, 1, 3).reshape(-1, cout).contiguous()
            try:
                mm = torch._int_mm(a_mat, b_mat)
                mm_ms = _timing.graph_ms(lambda: torch._int_mm(a_mat, b_mat),
                                         it)
                mm_same = torch.equal(mm.reshape(-1), ki.conv_int8_plain(
                    xq, sx, conv.w_q, ws, b, raw=True, **kw).reshape(-1))
            except RuntimeError as e:
                mm_ms, mm_same, int_mm_ok = None, f"refused ({e})", False
            xc = x.permute(0, 3, 1, 2)
            dnn_ms = _timing.graph_ms(lambda: F.conv2d(
                xc, conv.conv.w, conv.conv.b, stride=stride, padding=pad), it)
        work = ki.conv_int8_work(x_shape, w_shape, (stride, stride), pad,
                                 residual=has_res, amax=has_max)
        ho, wo = ki._out_hw(*x_shape[1:3], kh, kw_, (stride, stride), pad)
        tile = ki.tile_shape(ho, wo, stride)
        tiles = x_shape[0] * -(-wo // tile[0]) * -(-ho // tile[1])
        c_bound, c_by = _timing.bound_ms(work, peak=ki.PEAK_INT8_OPS)
        print(f"int8 I2 {w_shape} on {x_shape} s{stride} p{pad} act "
              f"{conv.act} residual {has_res} max {has_max} x{n} on {card}: "
              f"{c_ms:.4f} ms (plain {c_plain:.4f}, bound {c_bound:.4f} "
              f"{c_by}, {work[0]} int8 ops, {work[1]} B, tile "
              f"{tile} x {ki.n_tile(tiles, cout)}), "
              f"torch._int_mm on im2col {mm_ms} ms (sums equal: {mm_same}), "
              f"cuDNN bf16 conv {dnn_ms:.4f} ms", flush=True)
        for k, v in (("i2", c_ms), ("i2_plain", c_plain), ("i2_bound", c_bound),
                     ("int_mm", mm_ms or 0.0), ("cudnn", dnn_ms)):
            tot[k] += n * v
        if c_by == "operations":
            i2_ops_time += n * c_bound
    xs = {tuple(v[0].shape): v[0] for v in seen.values()}
    for (kind_, shape), n in sorted(i1_calls.items(), key=str):
        x = xs[shape]
        with torch.inference_mode():
            if kind_ == "max":
                slot = torch.zeros(1, device="cuda")
                k_ms, p_ms, _ = timed(lambda: ki.act_amax(x, slot),
                                      lambda: ki.act_amax_plain(x), it,
                                      graphed=True)
                bound, _ = _timing.bound_ms(ki.amax_work(shape, 2),
                                            peak=ki.PEAK_FP32_FLOPS)
                # the library's one call for max|x| over the whole tensor
                # (exact in bf16, as a max is)
                lib = torch.linalg.vector_norm(x, float("inf"))
                lib_same = torch.equal(lib.float(), ki.act_amax_plain(x))
                lib_ms = _timing.graph_ms(
                    lambda: torch.linalg.vector_norm(x, float("inf")), it)
                tot["amax_lib"] += n * lib_ms
                keys = ("amax", "amax_plain", "amax_bound")
            else:
                slots = torch.full((kind_,), 1.0, device="cuda")
                sl = [slots[i:i + 1] for i in range(kind_)]
                k_ms, p_ms, _ = timed(
                    lambda: ki.quantize_act(x, sl),
                    lambda: ki.quantize_act_plain(x, slots.amax()), it,
                    graphed=True)
                bound, _ = _timing.bound_ms(ki.quantize_work(shape, 2, kind_),
                                            peak=ki.PEAK_FP32_FLOPS)
                keys = ("i1", "i1_plain", "i1_bound")
        what = ("max pass" if kind_ == "max"
                else f"quantize from {kind_} slot(s)")
        lib_txt = ("" if kind_ != "max" else
                   f", torch.linalg.vector_norm(x, inf) {lib_ms:.4f} ms "
                   f"(equal to the plain max: {lib_same})")
        print(f"int8 I1 {what} on {shape} x{n} on {card}: {k_ms:.4f} ms "
              f"(plain {p_ms:.4f}, bound {bound:.4f} bytes{lib_txt})",
              flush=True)
        for k, v in zip(keys, (k_ms, p_ms, bound)):
            tot[k] += n * v
    print(f"int8 detector's step at ({BATCH}, {DET_HW[0]}, {DET_HW[1]}) on "
          f"{card}, summed, each alone in a CUDA graph: I1 max pass "
          f"{tot['amax']:.4f} ms (plain {tot['amax_plain']:.4f}, bound "
          f"{tot['amax_bound']:.4f}, vector_norm {tot['amax_lib']:.4f}), I1 "
          f"quantize {tot['i1']:.4f} ms (plain {tot['i1_plain']:.4f}, bound "
          f"{tot['i1_bound']:.4f}), I2 {tot['i2']:.4f} ms (plain "
          f"{tot['i2_plain']:.4f}, bound {tot['i2_bound']:.4f}), "
          f"torch._int_mm {tot['int_mm']:.4f} ms"
          f"{'' if int_mm_ok else ' (refused at some shapes)'}, cuDNN bf16 "
          f"{tot['cudnn']:.4f} ms", flush=True)
    # the quantize has no one PyTorch call (its scale comes from the slots)
    for name, key, lib in (("act_amax", "amax", tot["amax_lib"]),
                           ("quantize_act", "i1", None)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lpr_tpu_torch/csrc/conv_int8.cu",
            "replaces": "lpr_tpu/ops/nn.py:129", "launches": None,
            "max_abs_err": err[key], "ms": tot[key],
            "plain_ms": tot[key + "_plain"], "bound_ms": tot[key + "_bound"],
            "bound_by": "bytes", "library_ms": lib,
        })
    kernels.append({
        "name": "conv_int8", "route": "cuda",
        "source": "lpr_tpu_torch/csrc/conv_int8.cu",
        "replaces": "lpr_tpu/ops/nn.py:129", "launches": None,
        "max_abs_err": err["i2"], "ms": tot["i2"], "plain_ms": tot["i2_plain"],
        "bound_ms": tot["i2_bound"],
        "bound_by": ("operations" if i2_ops_time >= tot["i2_bound"] / 2
                     else "bytes"),
        "library_ms": tot["int_mm"] if int_mm_ok else None,
    })
    phase("int8", t, f"; {n_run} int8 convs, {n_quant} quantizes and {n_max} "
          f"max pass a step, I1/I2 bit for bit at every shape")

    # ---- 6. slice -------------------------------------------------------
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer, to_host)

    t = time.perf_counter()
    char, _, ck = load_char_ocr_npz(CKPT_CHAR)
    names = ck.names
    P = PipelineConfig().max_plates
    expect = {"plate_boxes": (BATCH, P, 4), "plate_scores": (BATCH, P),
              "plate_classes": (BATCH, P), "plate_valid": (BATCH, P),
              "is_long": (BATCH, P), "sr": (BATCH, P, 32, 192, 1)}
    for grp in ("chars_orig", "chars_sr"):
        expect.update({f"{grp}.boxes": (BATCH, P, 16, 4),
                       f"{grp}.scores": (BATCH, P, 16),
                       f"{grp}.classes": (BATCH, P, 16),
                       f"{grp}.valid": (BATCH, P, 16),
                       f"{grp}.count": (BATCH, P)})

    def check_outputs(out):
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
                raise AssertionError(f"{k}: shape {tuple(v.shape)} != "
                                     f"{shape}")
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise AssertionError(f"{k}: non-finite values")

    def check_head(rec, plain_head, label):
        """The detector's raw head through the kernels against the head
        through their plain versions, on the step's own detector input:
        the letterboxed frames in bf16, or the host-letterboxed bytes."""
        with torch.inference_mode():
            if rec.cfg.packed_input:
                lb = torch.as_tensor(rec.host_letterbox(frames),
                                     device="cuda")
                raw_k = rec.plate_model(None, front=rec._front, mid=rec._mid,
                                        packed=lb)
            else:
                x = torch.as_tensor(frames, device="cuda").to(torch.bfloat16)
                lb = letterbox(x / 255.0, DET_HW, fill=0.0)[0].contiguous()
                raw_k = rec.plate_model(lb, front=rec._front, mid=rec._mid)
            raw_p = plain_head(rec, lb)
        head_max = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(raw_k, raw_p))
        head_mean = max((a.float() - b.float()).abs().mean().item()
                        for a, b in zip(raw_k, raw_p))
        print(f"detector raw head, {label}: max_abs_err {head_max} "
              f"(< {HEAD_MAX_ERR}), worst level mean {head_mean} "
              f"(< {HEAD_MEAN_ERR})", flush=True)
        if not (head_max < HEAD_MAX_ERR and head_mean < HEAD_MEAN_ERR):
            raise AssertionError(f"detector head disagrees: {label}")

    def throughput(step, label):
        steps, rounds = 5, 3
        for _ in range(2):
            step(frames)
        torch.cuda.synchronize()
        step_ms = []
        for _ in range(rounds):
            t_run = time.perf_counter()
            for _ in range(steps):
                step(frames)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t_run) / steps)
        best = min(step_ms)
        print(f"slice throughput, {label}: {1e3 * BATCH / best:.3f} frames/s"
              f" at the best of {rounds} rounds of {steps} steps (ms/step "
              f"{step_ms}; batch {BATCH}, 720p, det {DET_HW[0]}x{DET_HW[1]},"
              f" bf16; host clock around synchronize) on {card}", flush=True)

    def identical(a, b):
        return all(identical(a[k], b[k]) if isinstance(a[k], dict)
                   else a[k] is None or torch.equal(a[k], b[k]) for k in a)

    def drive(label, plain_head, need, plate_model=None, **cfg_kw):
        """The recognizer at the production configuration (and cfg_kw):
        its first step captures the graph; the launch counts are read
        around the second, a replay; the graph's outputs must be the eager
        step's bit for bit; then both are timed.  Returns the recognizer,
        its results, the counts and the replay's outputs on the host."""
        r = PlateRecognizer(plate if plate_model is None else plate_model,
                            char, load_lpsr(CKPT_LPSR),
                            PipelineConfig(det_hw=DET_HW,
                                           dtype=torch.bfloat16, **cfg_kw),
                            char_names=names)
        r.step_raw(frames)
        counts_to_zero()
        o = r.step_raw(frames)
        torch.cuda.synchronize()
        c = counts()
        if min(c[k] for k in need) < 1:
            raise AssertionError(f"the {label} slice did not launch "
                                 f"{need}: {c}")
        check_outputs(o)
        if not identical(o, r.step_eager(frames)):
            raise AssertionError(f"{label}: the graph's outputs differ "
                                 f"from the eager step's")
        if plain_head is not None:
            check_head(r, plain_head, label)
        host = to_host(o)
        res = r.assemble(host)
        print(f"slice {label}: {sum(len(f) for f in res)} plates in {BATCH} "
              f"frames; first texts "
              f"{[p['text_sr'] for f in res for p in f][:6]}"
              f"; graph replay's launches {c} (graph holds "
              f"{next(iter(r._graphs.values())).launches}); outputs equal "
              f"to the eager step's, bit for bit", flush=True)
        throughput(r.step_raw, f"{label}, frozen (one CUDA graph)")
        throughput(r.step_eager, f"{label}, eager")
        return r, res, c, host

    # The default configuration (K1 and K2), the step frozen into a graph.
    rec, results, slice_counts, out_default = drive(
        "default", lambda r, lb: r.plate_model.forward_from(
            kf.front_plain(lb, r._front), 3), ("yolo_front", "lpsr"))
    # packed_input: the host letterbox, K1's uint8 instance, K2.
    rec_packed, results_packed, packed_counts, _ = drive(
        "packed_input", lambda r, lb: r.plate_model.forward_from(
            kf.front_plain(lb, r._front), 3), ("yolo_front_u8", "lpsr"),
        packed_input=True)
    # fused_mid: K1, K3 and K2.
    _, _, mid_counts, _ = drive(
        "fused_mid", lambda r, lb: r.plate_model.forward_from(
            km.mid_plain(kf.front_plain(lb, r._front), r._mid), 5),
        ("yolo_front", "yolo_mid", "lpsr"), fused_mid=True)
    # int8_detector: K1 (float), then I1 + I2 for every quantized conv,
    # K2; quantized from a float32 detector as the recognizer does it.  Its
    # plates and strings beside the bf16 recognizer's: the boxes of frames
    # whose plates are valid in both held to the JAX test's 6 px
    # (tests/test_pipeline.py:238-262), the rest reported.
    _, results_int8, int8_counts, out_int8 = drive(
        "int8_detector", None, ("yolo_front", "act_amax", "quantize_act",
                                "conv_int8", "lpsr"),
        plate_model=load_plate_detector(CKPT_PLATE), int8_detector=True)
    i_counts = tuple(int8_counts[k] for k in ("act_amax", "quantize_act",
                                              "conv_int8"))
    print(f"slice int8_detector: a step launches I1's max pass "
          f"{i_counts[0]} time(s), its quantize {i_counts[1]} times (one a "
          f"distinct tensor), I2 {i_counts[2]} times", flush=True)
    if i_counts != (1, 43, 50):
        raise AssertionError(f"int8 step launches (max pass, quantize, I2) "
                             f"{i_counts}, not (1, 43, 50)")
    same_valid = (out_int8["plate_valid"] == out_default["plate_valid"]
                  ).all(axis=1)
    d_box = max((float(np.abs(out_int8["plate_boxes"][i][v]
                              - out_default["plate_boxes"][i][v]).max())
                 for i, v in enumerate(out_default["plate_valid"])
                 if same_valid[i] and v.any()), default=0.0)
    print(f"slice int8_detector beside bf16 on {card}: plate_valid equal in "
          f"{int(same_valid.sum())} of {BATCH} frames; box max diff "
          f"{d_box:.3f} px there (< 6); strings int8 "
          f"{[(p['text'], p['text_sr']) for f in results_int8 for p in f]}"
          f" against bf16 "
          f"{[(p['text'], p['text_sr']) for f in results for p in f]}",
          flush=True)
    if d_box >= 6.0:
        raise AssertionError(f"int8 boxes {d_box} px from the bf16 ones")
    # lazy_decode=False: the whole grid decoded, nms_batched; held to the
    # lazy step's boxes and scores within 1e-3 (tests/test_yolo.py:163-195).
    _, _, eager_counts, out_eager = drive(
        "lazy_decode=False", lambda r, lb: r.plate_model.forward_from(
            kf.front_plain(lb, r._front), 3), ("yolo_front", "lpsr"),
        lazy_decode=False)
    if not (out_eager["plate_valid"] == out_default["plate_valid"]).all():
        raise AssertionError("lazy_decode=False: plate_valid differs")
    d_eager = max(float(np.abs(out_eager[k] - out_default[k]).max())
                  for k in ("plate_boxes", "plate_scores"))
    print(f"slice lazy_decode=False beside the lazy step: plate_valid "
          f"equal, boxes and scores max diff {d_eager} (< 1e-3)", flush=True)
    if d_eager >= 1e-3:
        raise AssertionError(f"lazy_decode=False differs from the lazy step "
                             f"by {d_eager}")
    phase("slice", t, f"; launches default {slice_counts}, packed_input "
          f"{packed_counts}, fused_mid {mid_counts}, int8 {int8_counts}, "
          f"lazy_decode=False {eager_counts}")

    # ---- 7. stages ------------------------------------------------------
    from lpr_tpu_torch.tools import profile_stages

    t = time.perf_counter()
    step_row, rows, alt = profile_stages.split_rows(rec, frames, calls=2,
                                                    rounds=1)
    alt.insert(0, profile_stages.eager_step_row(rec, frames, 2, 1))
    print(f"stages: the default step by stage on {card}; batch {BATCH}, "
          f"720p, det {DET_HW[0]}x{DET_HW[1]}, bf16; the step row one graph "
          f"replay, the stages and 'step, eager' op by op; launches = "
          f"kernels executed, host calls = launches issued; per call, one "
          f"round of 2 calls", flush=True)
    for line in profile_stages.report(step_row, rows, alt):
        print(f"stages: {line}", flush=True)
    for r in profile_stages.frozen_rows(
            rec, frames, profile_stages.stage_split(rec, frames)[1], 2, 1):
        print(f"stages, frozen (each alone as a CUDA graph): {r.line()}",
              flush=True)
    phase("stages", t)

    # ---- 8. serve -------------------------------------------------------
    from lpr_tpu_torch.serve.server import InferenceServer, ServeConfig

    t = time.perf_counter()
    requests = np.concatenate([frames, frames])
    counts_to_zero()
    srv = InferenceServer(rec, ServeConfig(max_batch=BATCH,
                                           max_delay_ms=20.0)).start()
    try:
        futs = srv.submit_many(requests)
        served = [f.result(timeout=300) for f in futs]
    finally:
        srv.stop(timeout=60)
    serve_counts = counts()
    print(f"serve stats: {json.dumps(srv.stats.summary())}", flush=True)
    if serve_counts["yolo_front"] < 1 or serve_counts["lpsr"] < 1:
        raise AssertionError(f"the server did not launch K1 and K2: "
                             f"{serve_counts}")

    def key(res):
        return [(p["class_id"], p["text"], p["text_sr"]) for p in res]

    if [key(r) for r in served] != [key(r) for r in results + results]:
        raise AssertionError("served results differ from recognize()")

    import tempfile
    import urllib.request

    from lpr_tpu_torch import native
    from lpr_tpu_torch.serve.http import HttpFrontend
    from lpr_tpu_torch.tools.synth import png_bytes, write_png

    def serve_path(label, r, need, want, drive_server):
        """One served path: counts to 0, a server at the served shape,
        drive_server(srv) -> answers, stop(), counts read; the answers
        must equal ``want`` and every kernel in ``need`` must have
        launched."""
        counts_to_zero()
        srv = InferenceServer(r, ServeConfig(max_batch=BATCH,
                                             max_delay_ms=20.0,
                                             frame_hw=FRAME_HW)).start()
        try:
            got = drive_server(srv)
        finally:
            srv.stop(timeout=60)
        torch.cuda.synchronize()
        c = counts()
        if min(c[k] for k in need) < 1:
            raise AssertionError(f"serve {label} did not launch {need}: {c}")
        if [key(x) for x in got] != [key(x) for x in want]:
            raise AssertionError(f"serve {label}: answers differ from "
                                 f"recognize()")
        print(f"serve {label}: {len(got)} answers equal to recognize(); "
              f"launches {c}; stats {json.dumps(srv.stats.summary())}",
              flush=True)
        return c

    def results_of(futs):
        return [f.result(timeout=300) for f in futs]

    path_counts = {}
    if decode_missing:
        print(f"serve files and bytes: not driven (no "
              f"{' or '.join(decode_missing)} on this machine)", flush=True)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            paths = [os.path.join(tmp, f"frame{i}.png")
                     for i in range(BATCH)]
            for p_, f_ in zip(paths, frames):
                write_png(p_, f_)
            path_counts["files"] = serve_path(
                "submit_path + submit_paths (8 PNG files each)", rec,
                ("yolo_front", "lpsr"), results + results,
                lambda srv: results_of([srv.submit_path(p_) for p_ in paths]
                                       + srv.submit_paths(paths)))
        path_counts["bytes"] = serve_path(
            "submit_bytes (8 PNG)", rec, ("yolo_front", "lpsr"), results,
            lambda srv: results_of([srv.submit_bytes(png_bytes(f_))
                                    for f_ in frames]))
        # an image of another shape: fitted with Pillow's bilinear
        # resample (the port's C copy), centred, as the JAX server does
        small = synth_frames(1, (360, 640), SEED + 1)[0]
        r_ = min(FRAME_HW[0] / 360, FRAME_HW[1] / 640)
        nh_, nw_ = round(360 * r_), round(640 * r_)
        top_, left_ = (FRAME_HW[0] - nh_) // 2, (FRAME_HW[1] - nw_) // 2
        fitted = np.zeros((*FRAME_HW, 3), np.uint8)
        fitted[top_:top_ + nh_, left_:left_ + nw_] = (
            native.resize_pil_bilinear(small, (nh_, nw_)))
        path_counts["bytes 360x640"] = serve_path(
            "submit_bytes (one 360x640 PNG)", rec, ("yolo_front", "lpsr"),
            rec.recognize(np.stack([fitted] * BATCH))[:1],
            lambda srv: results_of([srv.submit_bytes(png_bytes(small))]))

    def pool_run(srv):
        srv.preload(frames)
        return results_of([srv.submit_ref(i) for i in range(BATCH)])

    path_counts["pool"] = serve_path(
        "pool (preload + submit_ref)", rec, ("yolo_front", "lpsr"), results,
        pool_run)
    path_counts["pool, packed_input"] = serve_path(
        "pool, packed_input (preload + submit_ref)", rec_packed,
        ("yolo_front_u8", "lpsr"), results_packed, pool_run)

    def http_run(srv):
        fe = HttpFrontend(srv, host="127.0.0.1", port=0).start()
        url = f"http://127.0.0.1:{fe.port}"

        def post(route, arr):
            buf = io.BytesIO()
            np.save(buf, arr)
            req = urllib.request.Request(url + route, data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=300) as resp:
                return json.loads(resp.read())

        try:
            with urllib.request.urlopen(url + "/v2/health/ready",
                                        timeout=60) as resp:
                if resp.status != 200 or resp.read() != b"READY":
                    raise AssertionError("HTTP health route")
            got = [post("/v2/models/pipeline/infer", frames[0])]
            got += post("/v2/models/pipeline/infer_batch", frames)
            with urllib.request.urlopen(url + "/v2/stats",
                                        timeout=60) as resp:
                stats = json.loads(resp.read())
            if stats["requests"] != 1 + BATCH:
                raise AssertionError(f"HTTP stats route: {stats}")
        finally:
            fe.stop()
        if any("sr" in p_ for r_ in got for p_ in r_):
            raise AssertionError("HTTP answers carry the sr crops")
        return got

    path_counts["http"] = serve_path(
        "HTTP (health, infer, infer_batch, stats)", rec,
        ("yolo_front", "lpsr"), results[:1] + results, http_run)
    phase("serve", t, f"; {len(served)} requests, launches {serve_counts}; "
          f"further paths {path_counts}")

    # ---- 9. apps --------------------------------------------------------
    t = time.perf_counter()
    apps_entry, apps_note = apps_phase(card, counts_to_zero, counts, timed,
                                       iters)
    kernels.append(apps_entry)
    phase("apps", t, f"; {apps_note}, K2 float32 launches in the "
          f"evaluator {apps_entry['launches']}")

    # ---- 10. export ------------------------------------------------------
    t = time.perf_counter()
    export_note = export_phase(card, counts_to_zero, counts)
    phase("export", t, f"; {export_note} on {card}")

    # ---- 11. serving -----------------------------------------------------
    from lpr_tpu_torch.tools import bench_serving

    t = time.perf_counter()
    brief = ["--clients", "16", "--frames", "4", "--max-batch", "8"]
    modes = [[], ["--pool"], ["--http"]] + ([] if decode_missing
                                            else [["--files"]])
    for m in modes:
        if bench_serving.main(brief + m) != 0:
            raise AssertionError(f"bench_serving {m}")
    phase("serving", t, f"; modes {[m or ['frames'] for m in modes]}")

    # ---- 12. bench -------------------------------------------------------
    from lpr_tpu_torch import bench

    t = time.perf_counter()
    bench_counts = {}
    for mode, int8 in (("1", "0"), ("0", "0"), ("1", "1")):
        os.environ.update({"BENCH_PACKED": mode, "BENCH_INT8": int8,
                           "BENCH_REPS": "2", "BENCH_BATCH": "32",
                           "BENCH_STEPS": "30"})
        counts_to_zero()
        if bench.main([]) != 0:
            raise AssertionError(f"lpr_tpu_torch.bench BENCH_PACKED={mode} "
                                 f"BENCH_INT8={int8}")
        bench_counts[(mode, int8)] = counts()
    if min(bench_counts[("1", "1")][k] for k in ("act_amax", "quantize_act",
                                                  "conv_int8")) < 1:
        raise AssertionError(f"BENCH_INT8=1 did not launch I1 and I2: "
                             f"{bench_counts[('1', '1')]}")
    phase("bench", t, f"; launches packed {bench_counts[('1', '0')]}, raw "
          f"{bench_counts[('0', '0')]}, packed int8 "
          f"{bench_counts[('1', '1')]}")

    by_name = {k["name"]: k for k in kernels}
    by_name["yolo_front"]["launches"] = serve_counts["yolo_front"]
    by_name["yolo_front_u8"]["launches"] = packed_counts["yolo_front_u8"]
    by_name["lpsr"]["launches"] = serve_counts["lpsr"]
    by_name["yolo_mid"]["launches"] = mid_counts["yolo_mid"]
    by_name["act_amax"]["launches"] = int8_counts["act_amax"]
    by_name["quantize_act"]["launches"] = int8_counts["quantize_act"]
    by_name["conv_int8"]["launches"] = int8_counts["conv_int8"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
