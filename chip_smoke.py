#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (lpr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:

1. device  — the card's name and power limit (nvidia-smi); fails without a
   CUDA device.
2. build   — every kernel in lpr_tpu_torch/csrc (yolo_front K1 with its
   uint8 instance and its K4 stage variants, lpsr K2, yolo_mid K3,
   conv_int8 I1 and I2, crop_geometry G1, the step's stamp) built
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
   (csrc/host_letterbox.cc and csrc/host_augment.cc always;
   csrc/host_decode.cc, which links
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
   G1 at the served shapes (32 frames of 720x1280 and of 1080x1920, 16 of
   720x1280, three plate slots from the frames' own panels, empty slots
   as zero boxes), bf16 and float32, against its plain version in float32
   (crop_geometry.crop_errors), timed as CUDA graphs of repeated launches
   beside its bound (crop_work) and the plain version in bf16, the
   interpolation-matrix route the step took before G1.
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
   bit for bit (the step launches K1, K2 and G1 once each, no other kernel);
   char_ocr_synth.npz the same way
   through load_char_detector, its detections on 8 plate crops equal to
   the npz's; LPSR emitted as ONNX and loaded back, K2 float32 (64 crops)
   and bf16 (24 crops) on it equal to K2 on the npz model bit for bit;
   run_onnx on the card against LPSR.forward (float32, within
   ONNX_RUN_TOL); export_lpsr and export_detector (the .pt detector at
   736x1280) to .pt2 programs, loaded back and run on the card against the
   forwards (within PT2_TOL).
11. train — the enhancement stage's training on the card (temporary files
   only): the repo's 16 plate crops (tests/fixtures/real_plates*) at
   64x384, repeated to 32, degraded by LPDegradation with draws sampled on
   the card, and the same draws applied on the CPU (within DEG_TOL), ms a
   batch; the LPSR trainer warm-started from lpsr_synth_glare at batch 128
   of degraded crops, one step on the card with TF32 off against the same
   step on the CPU (loss, gradients and every weight, TRAIN_*), then 20
   steps timed by bench_train_step.bench_lpsr (median ms and images/s,
   TF32 off and on), then validate on two batches of 64, which must launch
   K2's float32 instance once a batch, its mean PSNR and per-image PSNR
   within PSNR_TOL_DB of LPSR.forward's on the trained leaves; the
   CycleGAN trainer at batch 4 (9 blocks, base 64, the 64-512 PatchGAN),
   one generator step against the CPU's (its gradients, on each side,
   against float64 on the CPU: CG_GRAD_K), two full steps timed (losses
   finite); and the create_lr (--gan-weights cyclegan_real_g.npz),
   train_lpsr and train_cyclegan CLIs for one epoch on 8 crops, whose
   checkpoints must load in the flat layout.  Its K2 launches are printed
   on its line, not counted in the kernels line.
12. train_det — the detector trainers on the card (temporary files
   only): a PNG tree of 32 synthetic 720p frames with their panels as
   labels; YoloDataset with the defaults' augmentation (mosaic) through
   csrc/host_augment.cc, one sample equal byte for byte to the same sample
   through the plain numpy versions, the loader's images/s; one
   YoloTrainer step of yolov5s nc=11 at 640x640, batch 2, float32, TF32
   off, past warm-up, on the card against the same step on the CPU (loss,
   gradients against float64 on the CPU, every weight, the running
   statistics: DET_*), then steps at batch 16 timed by
   bench_train_step.bench_det (TF32 off and on, FLOPs and peak share);
   validate_map on the EMA weights, and on plate_det640.npz over the
   tree's labels on the card and on the CPU (DET_VAL_*); cli/train_yolo
   for one epoch on the tree (batch 16, --cache), whose last.npz must
   load through load_plate_detector and run.  No kernel is on this path.
13. parallel — data parallelism on the card: NCCL started at world size
   1 (one rank a card; a file:// store in a temporary directory), the
   LPSR trainer (phase train's batch 128) and the detector trainer
   (train_det's yolov5s at 640x640, batch 16, past warm-up) with
   make_mesh() against the same trainers without a mesh for two steps
   (the losses within 2e-6 relative, the weights after one step within
   1e-5, their sum after two within 1e-5 relative: the CPU parity bounds),
   each step timed with and without the all-reduces, LPSR's validate
   through K2 float32 on both; PlateRecognizer with
   make_mesh(devices=[card, card]) (two replicas, each with its own K1 and
   K2 packs and CUDA graph) against the unsharded recognizer at the
   slice's configuration (plate_valid and classes equal, boxes within 0.5
   px, strings equal; K1 and K2 launched twice a step), both timed;
   autobatch for the plate detector at 736x1280 bf16 and LPSR at 32x192
   bf16, each chosen batch run and its measured peak within its budget
   (lpr_tpu_torch.tools.validate_autobatch, with the marginal bytes a
   sample over the estimate).
14. serving — lpr_tpu_torch.tools.bench_serving, briefly (16 clients x 4
   requests, max_batch 8), with frames, with the pool, over HTTP and, where
   host_decode built, with files: its JSON lines (client frames/s, latency
   p50/p99, mean batch, the card).
15. bench  — lpr_tpu_torch.bench (batch 32, 30 chained steps, BENCH_REPS=2)
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
        # the step's own launches: K1, K2 and G1 once, nothing else
        counts_to_zero()
        got = rec.step_eager(frames)
        torch.cuda.synchronize()
        c = {k: v for k, v in counts().items() if v}
        if c != {"yolo_front": 1, "lpsr": 1, "plate_crops": 1}:
            raise AssertionError(f"the .pt detector's step launched {c}, "
                                 f"not K1, K2 and G1 once each")
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


# The train phase: the repo's plate crops, degraded from the HR size the
# LR tool uses (twice 32x192) in batches of 32; LPSR steps at batch 128 and
# validation in batches of 64 (K2's float32 instance); CycleGAN steps at
# the CLI's batch of 4.
TRAIN_CROPS = EVAL_FOLDERS
TRAIN_HR_HW = (64, 384)
DEG_BATCH = 32
LPSR_TRAIN_BATCH = 128
LPSR_VAL_BATCH = 64
LPSR_TIMED_STEPS = 20
CG_BATCH = 4
# The same draws applied on the card and on the CPU (float32, TF32 off):
# the LR batches' largest difference on [0, 1].
DEG_TOL = 1e-5
# One training step on the card against the same step on the CPU (TF32
# off): the loss within TRAIN_LOSS_RTOL; each weight within
# TRAIN_PARAM_TOL plus what the gradients' own difference moves a first
# Adam step, lr * g / (|g| + eps): at most lr * |g_card - g_cpu| / (min |g|
# + eps) between two gradients of one sign, 2 lr between two of opposite
# signs.  The gradients (read from Adam's first moment) in norm, tensor by
# tensor:
# - LPSR: within TRAIN_GRAD_RTOL of the CPU's, ||g_card - g_cpu|| /
#   ||g_cpu|| (elementwise they differ more: a pre-activation within
#   rounding of 0 takes the other side of a ReLU);
# - the CycleGAN generator: float32 rounding alone moves its gradients by
#   a few 1e-3 in norm (the CPU's float32 against float64 on the same
#   batch, printed each run), so both sides are held to a float64
#   reference on the CPU, the card's worst error there within CG_GRAD_K
#   times the CPU's.  The biases that InstanceNorm follows are left out:
#   their true gradient is zero, what is left is rounding noise.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-2
TRAIN_PARAM_TOL = 1e-6
CG_GRAD_K = 4
# Per-image PSNR of validate (K2 float32) against LPSR.forward (float32,
# TF32 off), in dB.
PSNR_TOL_DB = 0.01


def _adam_grads(opt, params, b1):
    """{key: the first step's gradient, on the CPU} from Adam's first
    moment, (1 - b1) g."""
    return {k: opt.state[p]["exp_avg"].cpu() / (1 - b1)
            for k, p in params.items()}


def _norm_err(got, ref, skip=lambda k: False):
    """The worst ||got - ref|| / ||ref|| over the tensors, and where (with
    that tensor's largest elementwise error over its largest |ref|)."""
    err, at = 0.0, None
    for k, r in ref.items():
        d = got[k].double() - r.double()
        if skip(k) or float(r.norm()) == 0:
            continue
        e = float(d.norm() / r.double().norm())
        if e > err:
            err, at = e, (f"{k} (elementwise max err / max|g| "
                          f"{float(d.abs().max() / r.abs().max())})")
    return err, at


def _step_errors(card_params, card_opt, cpu_params, cpu_opt, lr, b1,
                 noise=lambda k: False):
    """One Adam step on the card against the CPU's, from the same weights
    (see TRAIN_GRAD_RTOL): (the largest norm-wise gradient error, the
    largest weight error over its bound, the largest weight error, where
    the largest gradient error is and its largest elementwise error over
    the tensor's largest |g|)."""
    import torch

    eps = cpu_opt.defaults["eps"]
    g_cpu = _adam_grads(cpu_opt, cpu_params, b1)
    g_card = _adam_grads(card_opt, card_params, b1)
    g_err, worst = _norm_err(g_card, g_cpu, noise)
    w_ratio = w_err = 0.0
    for k, p in cpu_params.items():
        g_p, g_c = g_cpu[k], g_card[k]
        dg = (g_c - g_p).abs()
        same = (g_c * g_p) > 0
        lo = torch.minimum(g_c.abs(), g_p.abs())
        bound = TRAIN_PARAM_TOL + torch.where(
            same, lr * dg / (lo + eps), torch.full_like(dg, 2 * lr))
        d = (card_params[k].detach().cpu() - p.detach()).abs()
        w_ratio = max(w_ratio, float((d / bound).max()))
        w_err = max(w_err, float(d.max()))
    return g_err, w_ratio, w_err, worst


def _generator_grads_f64(gs, ds, real_a, real_b):
    """The CycleGAN generator step's gradients in float64 on the CPU from
    the flat states ``gs`` ({"ab", "ba"}) and ``ds``: {"ab": {key: g},
    "ba": ...}."""
    import torch

    from lpr_tpu_torch.train.cyclegan import CycleGANTrainer

    t = CycleGANTrainer(device="cpu")
    st = t.state_from(gs, ds)
    for which in ("ab", "ba"):
        st["g"][which] = {k: v.detach().double().requires_grad_(True)
                          for k, v in st["g"][which].items()}
        t.gens[which] = t.gens[which].double()
    st["d"] = {which: {k: v.detach().double() for k, v in d.items()}
               for which, d in st["d"].items()}
    loss, _ = t.g_loss(st, real_a.cpu().double(), real_b.cpu().double())
    keys = [(w, k) for w in ("ab", "ba") for k in st["g"][w]]
    grads = torch.autograd.grad(loss, [st["g"][w][k] for w, k in keys])
    out = {"ab": {}, "ba": {}}
    for (w, k), g in zip(keys, grads):
        out[w][k] = g
    return out


def train_phase(card, counts_to_zero, counts, dev="cuda"):
    """Phase train: the LR degradation on the card against the CPU, the
    LPSR trainer (a step against the CPU's, timed steps, validate through
    K2's float32 instance), the CycleGAN trainer (a generator step against
    the CPU's, two timed steps), and the create_lr, train_lpsr and
    train_cyclegan CLIs in a temporary directory; returns a note for the
    phase line.  ``dev="cpu"`` (with smaller batches) rehearses it where
    there is no card."""
    import contextlib
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lpr_tpu_torch import imageio, native
    from lpr_tpu_torch.cli import create_lr as cli_create_lr
    from lpr_tpu_torch.cli import train_cyclegan as cli_train_cg
    from lpr_tpu_torch.cli import train_lpsr as cli_train_lpsr
    from lpr_tpu_torch.data.datasets import luma_u8
    from lpr_tpu_torch.data.degradation import LPDegradation
    from lpr_tpu_torch.kernels import lpsr as kl
    from lpr_tpu_torch.models.cyclegan import (discriminator_init,
                                               generator_init)
    from lpr_tpu_torch.tools import _timing, bench_train_step
    from lpr_tpu_torch.train.cyclegan import CycleGANTrainer
    from lpr_tpu_torch.train.lpsr import LPSRTrainer, psnr
    from lpr_tpu_torch.weights.checkpoint import load_state

    note = {}

    @contextlib.contextmanager
    def tf32(on):
        """cuDNN's and cuBLAS's TF32 set to ``on``, restored after."""
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags

    device = torch.device(dev)

    def wall(fn):
        _timing.sync(device)
        t0 = time.perf_counter()
        out = fn()
        _timing.sync(device)
        return out, 1e3 * (time.perf_counter() - t0)

    # 1. degrade: the crops at the HR size, repeated to 32, the draws
    # sampled on the card, applied there and on the CPU
    t0 = time.perf_counter()
    files = sorted(p for f in TRAIN_CROPS
                   for p in glob.glob(os.path.join(f, "*.png")))
    crops = [imageio.read_rgb(p) for p in files]
    hr_u8 = np.stack([native.resize_pil_bicubic(c, TRAIN_HR_HW)
                      for c in crops])
    reps = -(-DEG_BATCH // len(crops))
    hr = torch.from_numpy(np.tile(hr_u8, (reps, 1, 1, 1))[:DEG_BATCH]
                          .astype(np.float32) / 255.0)
    hr_card = hr.to(dev)
    deg = LPDegradation(hr_hw=TRAIN_HR_HW)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with tf32(False), torch.no_grad():
        draws = deg.sample(gen, DEG_BATCH)
        lr_card = deg.apply(draws, hr_card)
        lr_cpu = deg.apply(draws.to("cpu"), hr)
        deg_err = float((lr_card.cpu() - lr_cpu).abs().max())
        deg_ms = _timing.event_ms(lambda: deg(gen, hr_card), 20, device)
    print(f"train degrade: {DEG_BATCH} crops of {TRAIN_HR_HW} from "
          f"{len(files)} files -> {tuple(lr_card.shape)}, card vs CPU on "
          f"the card's draws max_abs_err {deg_err} (< {DEG_TOL}); "
          f"{deg_ms:.3f} ms per batch of {DEG_BATCH} (sample + apply) on "
          f"{card} ({time.perf_counter() - t0:.2f} s)", flush=True)
    if not (deg_err < DEG_TOL and bool(torch.isfinite(lr_card).all())):
        raise AssertionError("the degradation on the card differs from "
                             "the CPU's on the same draws")
    note["degrade ms"] = deg_ms

    # 2. LPSR: (LR, HR) batches of 128 from the degradation, HR as the
    # datasets read it (Pillow's luma at 32x192)
    t0 = time.perf_counter()
    rgb = np.stack([native.resize_pil_bilinear(c, LPSR_HW) for c in crops])
    # image i of each degraded batch of 32 is crop (i % 32) % len(crops)
    idx = (np.arange(LPSR_TRAIN_BATCH) % DEG_BATCH) % len(crops)
    with torch.no_grad():
        lr_b = torch.cat([deg(gen, hr_card) for _ in range(
            LPSR_TRAIN_BATCH // DEG_BATCH)])
    hr_b = torch.from_numpy(luma_u8(rgb)[idx][..., None].astype(np.float32)
                            / 255.0).to(dev)
    start = load_state(CKPT_LPSR)[0]
    trainer, twin = LPSRTrainer(device=dev), LPSRTrainer(device="cpu")
    st, st_cpu = trainer.init(params=start), twin.init(params=start)
    with tf32(False):
        st, loss = trainer.step(st, lr_b, hr_b)
        st_cpu, loss_cpu = twin.step(st_cpu, lr_b.cpu(), hr_b.cpu())
    loss, loss_cpu = float(loss), float(loss_cpu)
    g_err, w_ratio, w_err, g_at = _step_errors(
        st["params"], st["opt"], st_cpu["params"], st_cpu["opt"],
        trainer.cfg.lr, 0.9)
    print(f"train lpsr step (batch {LPSR_TRAIN_BATCH}, warm start from "
          f"{CKPT_LPSR}, TF32 off): loss card {loss} CPU {loss_cpu} "
          f"(rel < {TRAIN_LOSS_RTOL}); gradients' relative error in norm "
          f"{g_err} "
          f"at {g_at} (< {TRAIN_GRAD_RTOL}); weights max_abs_err {w_err}, "
          f"max err / bound {w_ratio} (<= 1)", flush=True)
    if not (abs(loss - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu)
            and g_err < TRAIN_GRAD_RTOL and w_ratio <= 1
            and np.isfinite(loss)):
        raise AssertionError("the LPSR step on the card differs from the "
                             "CPU's")
    step_ms = {}
    for mode, on in (("fp32", False), ("tf32", True)):
        with tf32(on):
            rec = bench_train_step.bench_lpsr(device, LPSR_TIMED_STEPS,
                                              LPSR_TRAIN_BATCH)
        step_ms[mode] = rec["step_ms"]
    print(f"train lpsr step timed (bench_train_step.bench_lpsr: fresh "
          f"weights, random batches): median of {LPSR_TIMED_STEPS} after "
          f"{bench_train_step.WARMUP} warm-up, fp32 (TF32 off) "
          f"{step_ms['fp32']:.3f} ms = "
          f"{LPSR_TRAIN_BATCH / step_ms['fp32'] * 1e3:.1f} images/s, "
          f"cuDNN+cuBLAS TF32 {step_ms['tf32']:.3f} ms = "
          f"{LPSR_TRAIN_BATCH / step_ms['tf32'] * 1e3:.1f} images/s; "
          f"{rec['flops_per_step']:.4g} FLOP a step (3x the forward) on "
          f"{card}",
          flush=True)
    note["lpsr step ms"] = step_ms

    # validate through K2 float32 after the steps: one launch a batch of
    # 64; its PSNR against LPSR.forward on the trained leaves (float32,
    # TF32 off): per image on the weights validate packed, and the mean
    val = [(lr_b[i:i + LPSR_VAL_BATCH], hr_b[i:i + LPSR_VAL_BATCH])
           for i in range(0, LPSR_TRAIN_BATCH, LPSR_VAL_BATCH)]
    with tf32(False):
        counts_to_zero()
        mean_psnr, val_ms = wall(lambda: trainer.validate(st, val))
        val_launches = counts()["lpsr"]
        packed = kl.lpsr_pack(trainer.model)     # the weights validate ran
        with torch.no_grad():
            k2 = torch.cat([psnr(kl.lpsr_fused(x.contiguous(), packed)
                                 .clamp(0, 1), y) for x, y in val])
            ref = torch.cat([psnr(trainer.forward(st["params"], x)
                                  .clamp(0, 1), y) for x, y in val])
    d_db = float((k2 - ref).abs().max())
    d_mean = abs(mean_psnr - float(ref.mean()))
    print(f"train lpsr validate: {len(val)} batches of {LPSR_VAL_BATCH}, "
          f"K2 float32 launches {val_launches}, mean PSNR {mean_psnr:.4f} "
          f"dB, |mean - LPSR.forward's on the trained leaves| {d_mean} dB, "
          f"per image on validate's packed weights max {d_db} dB (each < "
          f"{PSNR_TOL_DB}); {val_ms:.2f} ms ({time.perf_counter() - t0:.2f}"
          f" s for the LPSR part)", flush=True)
    if (val_launches != len(val) or not d_db < PSNR_TOL_DB
            or not d_mean < PSNR_TOL_DB):
        raise AssertionError("validate did not run K2 float32 once a "
                             "batch on the trained weights, or its PSNR "
                             "disagrees")
    note["validate K2 launches"] = val_launches

    # 3. CycleGAN at the CLI's batch of 4: the production generator and
    # PatchGAN from one start on the card and the CPU; a generator step
    # compared, then two full steps timed
    t0 = time.perf_counter()
    g_cpu = torch.Generator().manual_seed(SEED)
    gs = {"ab": generator_init(g_cpu), "ba": generator_init(g_cpu)}
    ds = {"a": discriminator_init(g_cpu), "b": discriminator_init(g_cpu)}
    real_a = torch.from_numpy(rgb[:CG_BATCH].astype(np.float32) / 255.0
                              ).to(dev) * 2 - 1           # HR, [-1, 1]
    real_b = lr_b[:CG_BATCH] * 2 - 1                     # LR
    cg, cg_twin = CycleGANTrainer(device=dev), CycleGANTrainer(
        device="cpu")
    cs, cs_cpu = cg.state_from(gs, ds), cg_twin.state_from(gs, ds)
    with tf32(False):
        gl, _ = cg.g_step(cs, real_a, real_b)
        gl_cpu, _ = cg_twin.g_step(cs_cpu, real_a.cpu(), real_b.cpu())
    gl, gl_cpu = float(gl), float(gl_cpu)
    b1 = cg.cfg.beta1

    def normed(k):
        return k.endswith("/b") and not k.startswith("tail/")

    exact = _generator_grads_f64(gs, ds, real_a, real_b)
    errs = [_step_errors(
        cs["g"][which], cs["g_opt"], cs_cpu["g"][which], cs_cpu["g_opt"],
        cg.cfg.lr, b1, normed) for which in ("ab", "ba")]
    w_ratio, w_err = (max(e[i] for e in errs) for i in (1, 2))
    g_err, g_at = max((e[0], e[3]) for e in errs)
    card_err, card_at = max(_norm_err(
        _adam_grads(cs["g_opt"], cs["g"][w], b1), exact[w], normed)
        for w in ("ab", "ba"))
    cpu_err, cpu_at = max(_norm_err(
        _adam_grads(cs_cpu["g_opt"], cs_cpu["g"][w], b1), exact[w], normed)
        for w in ("ab", "ba"))
    print(f"train cyclegan generator step (batch {CG_BATCH}, 9 blocks base "
          f"64, PatchGAN 64-512, TF32 off): loss card {gl} CPU {gl_cpu} "
          f"(rel < {TRAIN_LOSS_RTOL}); gradients' worst relative error in "
          f"norm against float64 on the CPU: card {card_err} at {card_at}, "
          f"CPU float32 {cpu_err} at {cpu_at} (card <= {CG_GRAD_K} x CPU: "
          f"{card_err / cpu_err:.3f} x); card against CPU {g_err} at "
          f"{g_at}; weights max_abs_err {w_err}, max err / bound {w_ratio} "
          f"(<= 1)", flush=True)
    if not (abs(gl - gl_cpu) <= TRAIN_LOSS_RTOL * abs(gl_cpu)
            and card_err <= CG_GRAD_K * cpu_err and w_ratio <= 1):
        raise AssertionError("the CycleGAN generator step on the card "
                             "differs from the CPU's")
    note["cyclegan grad err vs f64 (card, CPU)"] = (card_err, cpu_err)
    cg_ms = []
    for _ in range(2):
        (cs, metrics), ms = wall(lambda: cg.step(cs, real_a, real_b))
        cg_ms.append(ms)
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"CycleGAN step losses {metrics}")
    print(f"train cyclegan steps: {[round(m, 3) for m in cg_ms]} ms "
          f"(batch {CG_BATCH}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}), losses {metrics} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    note["cyclegan step ms"] = cg_ms[-1]

    # 4. the CLIs on a handful of crops, on the card, in a temporary dir
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="lpr_train_")
    try:
        hr_dir = os.path.join(tmp, "hr")
        os.makedirs(hr_dir)
        for p in files[:8]:
            shutil.copy(p, hr_dir)
        lr_dir = os.path.join(tmp, "lr")
        cli_create_lr.main(["--hr-dir", hr_dir, "--out-dir", lr_dir,
                            "--gan-weights", "checkpoints/cyclegan_real_g.npz",
                            "--batch", "8", "--device", dev])
        made = sorted(os.listdir(lr_dir))
        if made != sorted(os.listdir(hr_dir)) or any(
                imageio.read_rgb(os.path.join(lr_dir, f)).shape
                != (*LPSR_HW, 3) for f in made):
            raise AssertionError(f"create_lr wrote {made}")
        ck = os.path.join(tmp, "ck")
        counts_to_zero()
        cli_train_lpsr.main(
            ["--hr-train-dir", hr_dir, "--lr-train-dir", lr_dir,
             "--hr-val-dir", hr_dir, "--lr-val-dir", lr_dir,
             "--batch-size", "4", "--epochs", "1", "--ckpt-dir", ck,
             "--runs-dir", os.path.join(tmp, "runs"), "--device", dev])
        cli_k2 = counts()["lpsr"]
        for name in ("best_model.npz", "last_model.npz"):
            got, _ = load_state(os.path.join(ck, name))
            if got.keys() != start.keys() or any(
                    got[k].shape != start[k].shape for k in got):
                raise AssertionError(f"train_lpsr's {name} has another "
                                     f"layout than {CKPT_LPSR}")
        cg_root = os.path.join(tmp, "cg")
        shutil.copytree(hr_dir, os.path.join(cg_root, "trainA"))
        shutil.copytree(lr_dir, os.path.join(cg_root, "trainB"))
        cg_ck = os.path.join(tmp, "cg_ck")
        cli_train_cg.main(["--dataroot", cg_root, "--epochs", "1",
                           "--ckpt-every", "1", "--ckpt-dir", cg_ck,
                           "--device", dev])
        for name in ("AtoB", "BtoA"):
            got, _ = load_state(os.path.join(cg_ck,
                                             f"netG_{name}_epoch_1.npz"))
            if got.keys() != gs["ab"].keys():
                raise AssertionError(f"train_cyclegan's netG_{name} has "
                                     f"another layout")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if cli_k2 < 1:
        raise AssertionError("train_lpsr's validation did not launch K2")
    print(f"train CLIs on the card: create_lr ({len(made)} crops, "
          f"--gan-weights cyclegan_real_g.npz), train_lpsr (1 epoch, batch "
          f"4; best/last_model.npz in the flat layout; K2 launches "
          f"{cli_k2}), train_cyclegan (1 epoch; netG_AtoB/BtoA_epoch_1.npz)"
          f" ({time.perf_counter() - t0:.2f} s)", flush=True)
    note["train_lpsr K2 launches"] = cli_k2
    return note


# The train_det phase: a 32-frame PNG tree of synthetic 720p frames with
# their panels as labels (tools/synth.py write_yolo_tree); the production
# detector trainer, yolov5s nc=11 at 640x640 float32, from yolo_init's
# weights; one step compared at batch DET_CMP_BATCH (the CPU side takes
# seconds a step at 640x640), past warm-up (step DET_CMP_STEP of 100 an
# epoch) so that every group of weights moves; steps timed at batch 16
# (the production step) with TF32 off and on.
DET_FRAMES = 32
DET_BATCH = 16
DET_CMP_BATCH = 2
DET_CMP_STEP = 1000
DET_TIMED_STEPS = 10
DET_WORKERS = 8
# One step on the card against the same step on the CPU (TF32 off), limits
# set before the first run:
# - the loss within DET_LOSS_RTOL relative;
# - the gradients (each side's first momentum less its weight decay, m = g
#   + wd * w) in norm, tensor by tensor, against float64 on the CPU: the
#   card's worst relative error within DET_GRAD_K times the CPU float32's
#   worst (as the CycleGAN generator's in phase train: batch statistics
#   amplify float32 rounding, and a pre-activation that rounds to exactly
#   0 meets the SiLU's flush on one side only), over the tensors whose
#   float64 gradient is above DET_GRAD_FLOOR of the largest (a bias before
#   a batch norm cancels to ~0 and carries noise only);
# - each weight within DET_PARAM_TOL plus lr * (1 + momentum) * |m_card -
#   m_cpu|: Nesterov SGD is linear in the gradient, so the bound is exact;
# - the running statistics within DET_STAT_RTOL of each tensor's largest.
DET_LOSS_RTOL = 1e-5
DET_GRAD_K = 4
DET_GRAD_FLOOR = 1e-4
DET_PARAM_TOL = 1e-6
DET_STAT_RTOL = 1e-5
# validate_map of plate_det640.npz (yolov5s nc=11) over the tree's labels
# (its panels are the detector's classes 7 and 8), on the card and on the
# CPU, float32 and TF32 off, limits set before the first run: mAP50 above
# DET_VAL_MAP50_MIN on both (0.753 on the CPU for this tree), and mAP50
# and mAP within DET_VAL_TOL of each other (a box's float32 difference
# moves an IoU by ~1e-6, which flips a match at one of the ten thresholds
# rarely; one flip among the tree's ~60 panels moves mAP by ~1e-3).
DET_VAL_MAP50_MIN = 0.5
DET_VAL_TOL = 1e-3


def _det_grads(trainer, state):
    """{key: the first step's gradient, float64 on the CPU}: the momentum
    after one step from zero less the weight decay it added."""
    from lpr_tpu_torch.train.yolo import _is_conv_weight

    wd = trainer.cfg.weight_decay
    out = {}
    for k, m in state["momenta"].items():
        g = m.detach().double().cpu()
        if _is_conv_weight(k):
            g = g - wd * state["_w0"][k]
        out[k] = g
    return out


def train_det_phase(card, dev="cuda"):
    """Phase train_det: the detector's data pipeline (a PNG tree, the
    host library against its plain numpy versions on one augmented
    sample, the loader's images/s), one YoloTrainer step on the card
    against the CPU's and float64's, timed steps at batch 16 (TF32 off and
    on), validate_map on the EMA weights, and cli/train_yolo for one epoch
    into a temporary directory, whose last.npz must load through
    load_plate_detector; returns a note for the phase line.  ``dev="cpu"``
    (with smaller module constants) rehearses it where there is no
    card."""
    import contextlib
    import random
    import shutil
    import tempfile
    import types

    import numpy as np
    import torch

    from lpr_tpu_torch import native
    from lpr_tpu_torch.cli import train_yolo as cli_train_yolo
    from lpr_tpu_torch.data import cv_plain
    from lpr_tpu_torch.data import yolo_data
    from lpr_tpu_torch.models.yolo import load_plate_detector, yolov5
    from lpr_tpu_torch.tools import bench_input, bench_train_step
    from lpr_tpu_torch.tools.synth import write_yolo_tree
    from lpr_tpu_torch.train.yolo import (_is_bias, _is_running_stat,
                                          validate_map)
    from lpr_tpu_torch.weights.checkpoint import load_state

    note = {}
    tmp = tempfile.mkdtemp(prefix="lpr_train_det_")

    @contextlib.contextmanager
    def tf32(on):
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags

    try:
        # 1. data: the tree, one augmented sample through the host library
        # and through the plain numpy versions (equal byte for byte), the
        # loader's rates
        t0 = time.perf_counter()
        img_dir, lbl_dir = write_yolo_tree(os.path.join(tmp, "tree"),
                                           DET_FRAMES)
        write_s = time.perf_counter() - t0
        ds = yolo_data.YoloDataset(img_dir, lbl_dir, (640, 640), seed=0,
                                   cache_images=True)
        ds.cache_all(workers=DET_WORKERS)
        host = ds.get(0, rng=random.Random(5))
        plain = types.SimpleNamespace(cv_resize_linear=cv_plain.resize_linear,
                                      cv_warp_affine=cv_plain.warp_affine,
                                      cv_hsv_lut=cv_plain.hsv_lut)
        yolo_data.native = plain
        try:
            ref = ds.get(0, rng=random.Random(5))
        finally:
            yolo_data.native = native
        if not (np.array_equal(host[0], ref[0])
                and np.array_equal(host[1], ref[1])):
            raise AssertionError("an augmented sample through the host "
                                 "library differs from its plain numpy "
                                 "versions")
        n_lab = int((host[1][:, 3] > 0).sum())
        cached = bench_input.epoch_rate(ds, DET_BATCH, 1)
        threaded = bench_input.epoch_rate(ds, DET_BATCH, 1, DET_WORKERS)
        print(f"train_det data: {DET_FRAMES} PNG frames 720x1280 written in "
              f"{write_s:.2f} s; a mosaic sample (640x640, {n_lab} labels) "
              f"through csrc/host_augment.cc equal to the plain numpy "
              f"versions byte for byte; loader on cached images "
              f"{cached:.1f} images/s on 1 thread, {threaded:.1f} with "
              f"{DET_WORKERS} workers ({time.perf_counter() - t0:.2f} s)",
              flush=True)
        note["loader images/s (1 thread, workers)"] = (round(cached, 1),
                                                       round(threaded, 1))

        # 2. one step: card, CPU float32, CPU float64 gradients
        t0 = time.perf_counter()
        x, lab = bench_train_step.det_batch(DET_CMP_BATCH)
        trainers = {side: bench_train_step.det_trainer(torch.device(d))
                    for side, d in (("card", dev), ("cpu", "cpu"))}
        w0 = trainers["cpu"].init(torch.Generator().manual_seed(SEED))
        w0 = {k: v.detach() for k, v in w0["params"].items()}
        states, totals = {}, {}
        with tf32(False):
            for side, tr in trainers.items():
                st = tr.init(params=w0)
                st["step"] = DET_CMP_STEP
                st, total, _ = tr.step(st, x, lab)
                st["_w0"] = {k: v.double() for k, v in w0.items()}
                states[side], totals[side] = st, float(total)
        twin = trainers["cpu"]
        p64 = {k: v.double().requires_grad_(not _is_running_stat(k))
               for k, v in w0.items()}
        from lpr_tpu_torch.models.yolo_train import train_forward
        from lpr_tpu_torch.train.yolo_loss import yolo_loss

        raws, _ = train_forward(twin.model, p64,
                                torch.from_numpy(x).double())
        t64, _ = yolo_loss(raws, torch.from_numpy(lab).double(),
                           twin.anchors.double())
        keys = [k for k, v in p64.items() if v.requires_grad]
        g64 = dict(zip(keys, torch.autograd.grad(
            t64, [p64[k] for k in keys], allow_unused=True)))
        g64 = {k: torch.zeros_like(p64[k]) if v is None else v.detach()
               for k, v in g64.items()}
        if set(g64) != set(states["card"]["momenta"]):
            raise AssertionError("the trainer's momenta are not one for "
                                 "each trainable tensor")
        g_card = _det_grads(trainers["card"], states["card"])
        g_cpu = _det_grads(twin, states["cpu"])
        top = max(float(v.norm()) for v in g64.values())

        def worst(g):
            err, at = 0.0, None
            for k, r in g64.items():
                n = float(r.norm())
                if n <= DET_GRAD_FLOOR * top:
                    continue
                e = float((g[k] - r).norm()) / n
                if e > err:
                    err, at = e, k
            return err, at

        card_err, card_at = worst(g_card)
        cpu_err, cpu_at = worst(g_cpu)
        lr_w, lr_b, mom = twin.rates(DET_CMP_STEP)
        w_ratio = stat_err = 0.0
        for k, p in states["cpu"]["params"].items():
            got = states["card"]["params"][k].detach().cpu().double()
            ref = p.detach().double()
            if _is_running_stat(k):
                stat_err = max(stat_err, float((got - ref).abs().max()
                                               / ref.abs().max()))
                continue
            dm = (states["card"]["momenta"][k].cpu().double()
                  - states["cpu"]["momenta"][k].double()).abs()
            bound = DET_PARAM_TOL + (lr_b if _is_bias(k) else lr_w) * (
                1 + mom) * dm
            w_ratio = max(w_ratio, float(((got - ref).abs() / bound).max()))
        loss_rel = abs(totals["card"] - totals["cpu"]) / abs(totals["cpu"])
        print(f"train_det step (yolov5s nc=11, 640x640, batch "
              f"{DET_CMP_BATCH}, float32, TF32 off, step {DET_CMP_STEP}: lr "
              f"{lr_w:.5f}, momentum {mom}): loss card {totals["card"]} CPU "
              f"{totals['cpu']} float64 {float(t64.detach())} (rel {loss_rel}, < "
              f"{DET_LOSS_RTOL}); gradients' worst relative error in norm "
              f"against float64: card {card_err} at {card_at}, CPU float32 "
              f"{cpu_err} at {cpu_at} (card <= {DET_GRAD_K} x CPU: "
              f"{card_err / max(cpu_err, 1e-12):.3f} x); weights max err / "
              f"bound {w_ratio} (<= 1); running statistics max err "
              f"{stat_err} of the largest (< {DET_STAT_RTOL}) "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        if not (loss_rel < DET_LOSS_RTOL
                and card_err <= DET_GRAD_K * max(cpu_err, 1e-7)
                and w_ratio <= 1 and stat_err < DET_STAT_RTOL):
            raise AssertionError("the detector step on the card differs "
                                 "from the CPU's")
        note["det grad err vs f64 (card, CPU)"] = (card_err, cpu_err)

        # 3. timed steps at batch 16, TF32 off and on
        t0 = time.perf_counter()
        step_ms, rec = {}, None
        for mode, on in (("fp32", False), ("tf32", True)):
            with tf32(on):
                rec = bench_train_step.bench_det(torch.device(dev),
                                                 DET_TIMED_STEPS, DET_BATCH)
            step_ms[mode] = rec["step_ms"]
        flops = rec["flops_per_step"]
        print(f"train_det step timed (bench_train_step.bench_det: yolov5s "
              f"nc=11 640x640 batch {DET_BATCH}, yolo_init weights, a "
              f"fixed random batch): median of {DET_TIMED_STEPS} after "
              f"{bench_train_step.WARMUP} warm-up, fp32 (TF32 off) "
              f"{step_ms['fp32']:.3f} ms = "
              f"{DET_BATCH / step_ms['fp32'] * 1e3:.1f} images/s, "
              f"cuDNN+cuBLAS TF32 {step_ms['tf32']:.3f} ms = "
              f"{DET_BATCH / step_ms['tf32'] * 1e3:.1f} images/s; "
              f"{flops:.4g} FLOP a step (flop_counter) = "
              f"{flops / (step_ms['fp32'] / 1e3) / 67e12 * 100:.1f} % of "
              f"67 TFLOP/s fp32, "
              f"{flops / (step_ms['tf32'] / 1e3) / 495e12 * 100:.1f} % of "
              f"495 TFLOP/s TF32 on {card} ({time.perf_counter() - t0:.2f} "
              f"s)", flush=True)
        note["det step ms"] = step_ms

        # 4. validate_map on the card step's EMA (a run check: random
        # weights find nothing), on plate_det640.npz on the card and the
        # CPU, and the CLI for one epoch
        t0 = time.perf_counter()
        val = yolo_data.YoloDataset(img_dir, lbl_dir, (640, 640),
                                    augment=False)

        def val_batches():
            return val.batches(DET_BATCH, shuffle=False, workers=DET_WORKERS)

        with tf32(False):
            metrics = validate_map(trainers["card"].model,
                                   states["card"]["ema"], val_batches(),
                                   device=dev)
            plate, _ = load_state(CKPT_PLATE)
            on_plate = {d: validate_map(yolov5("s", nc=11), plate,
                                        val_batches(), device=d)
                        for d in (dev, "cpu")}
        if not all(np.isfinite(metrics[k]) for k in ("map50", "map")):
            raise AssertionError(f"validate_map gave {metrics}")
        got, ref = on_plate[dev], on_plate["cpu"]
        val_err = max(abs(got[k] - ref[k]) for k in ("map50", "map"))
        print(f"train_det validate_map of {CKPT_PLATE} over the tree's "
              f"{DET_FRAMES} frames: card mAP50 {got['map50']} mAP "
              f"{got['map']}, CPU mAP50 {ref['map50']} mAP {ref['map']} "
              f"(mAP50 > {DET_VAL_MAP50_MIN} on both, difference {val_err}"
              f" <= {DET_VAL_TOL})", flush=True)
        if not (min(got["map50"], ref["map50"]) > DET_VAL_MAP50_MIN
                and val_err <= DET_VAL_TOL):
            raise AssertionError("validate_map of the plate checkpoint on "
                                 "the card differs from the CPU's or finds "
                                 "too little")
        note["det plate mAP50 (card, CPU)"] = (got["map50"], ref["map50"])
        ck = os.path.join(tmp, "ck")
        state = cli_train_yolo.main([
            "--img-dir", img_dir, "--label-dir", lbl_dir, "--nc", "11",
            "--arch", "yolov5s", "--imgsz", "640", "--batch-size",
            str(DET_BATCH), "--epochs", "1", "--cache", "--workers",
            str(DET_WORKERS), "--ckpt-dir", ck, "--runs-dir",
            os.path.join(tmp, "runs"), "--device", dev])
        det = load_plate_detector(os.path.join(ck, "last.npz"), device=dev)
        with torch.no_grad():
            pred, _ = det(torch.from_numpy(x).to(dev), decode=True)
        if not (state["step"] == DET_FRAMES // DET_BATCH
                and bool(torch.isfinite(pred).all())):
            raise AssertionError("cli/train_yolo's last.npz does not run")
        print(f"train_det validate_map on the EMA after the card's step: "
              f"mAP50 {metrics['map50']} mAP {metrics['map']}; "
              f"cli/train_yolo 1 epoch ({state['step']} steps, batch "
              f"{DET_BATCH}, --cache) on the PNG tree, last.npz loaded by "
              f"load_plate_detector and run ({time.perf_counter() - t0:.2f}"
              f" s)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return note


_T0 = time.perf_counter()


# The parallel phase: the trainers over NCCL at world size 1 (the machine
# has one card; NCCL takes one rank a card) against the same trainers
# without a mesh, at phase train's and train_det's sizes, two steps each;
# the recognizer with two replicas on the card against the unsharded one;
# autobatch's choices run on the card.  Limits, set before the first run:
# - the trainers: the CPU parity bounds of tests/test_torch_parallel.py
#   (tests/test_multiproc.py's): the losses within PAR_LOSS_RTOL relative,
#   every weight after the first step within PAR_PARAM_TOL, the weights'
#   sum after the second within PAR_PARAM_TOL relative;
# - the sharded recognizer: the slice's bounds, plate_valid and classes
#   equal, boxes within PAR_BOX_TOL px, strings equal;
# - autobatch: each chosen batch's measured peak within its budget.
PAR_LPSR_BATCH = LPSR_TRAIN_BATCH
PAR_DET_BATCH = DET_BATCH
PAR_DET_HW = (640, 640)
PAR_TIMED_STEPS = 5
PAR_LOSS_RTOL = 2e-6
PAR_PARAM_TOL = 1e-5
PAR_BOX_TOL = 0.5
PAR_AUTOBATCH = (("det", DET_HW), ("lpsr", LPSR_HW))


def parallel_phase(card, counts_to_zero, counts, dev="cuda"):
    """Phase parallel: NCCL started at world size 1 with a ``file://``
    store; LPSRTrainer and YoloTrainer with ``make_mesh()`` against the
    same trainers without a mesh (two steps, then the step times with and
    without the all-reduces); PlateRecognizer with
    ``make_mesh(devices=[card, card])`` (two replicas, K1 and K2 in each)
    against the unsharded recognizer at the slice's configuration;
    autobatch for the plate detector and LPSR, each chosen batch run
    (``tools/validate_autobatch.py``).  Returns a note for the phase line.
    ``dev="cpu"`` (gloo, smaller module constants) rehearses it where there
    is no card."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from lpr_tpu_torch.models.lpsr import LPSRConfig, load_lpsr
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector, yolov5)
    from lpr_tpu_torch.parallel.mesh import make_mesh
    from lpr_tpu_torch.parallel.multiproc import init_group
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer, to_host)
    from lpr_tpu_torch.tools import bench_train_step, validate_autobatch
    from lpr_tpu_torch.tools.synth import synth_frames
    from lpr_tpu_torch.train.lpsr import LPSRTrainer
    from lpr_tpu_torch.train.yolo import YoloTrainConfig, YoloTrainer
    from lpr_tpu_torch.weights.checkpoint import load_state

    note = {}
    device = torch.device(dev)
    tmp = tempfile.mkdtemp(prefix="lpr_parallel_")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step_ms(step, n):
        """Median host ms of ``n`` calls, each ended by a synchronize."""
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            step()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def fingerprint(params):
        return sum(float(v.detach().double().sum()) for v in params.values())

    def compare(label, losses, one, two):
        """Losses (mesh, plain) per step; weights after step one and two
        of each side."""
        for i, (a, b) in enumerate(losses):
            if not abs(a - b) <= PAR_LOSS_RTOL * abs(b):
                raise AssertionError(f"{label}: step {i} loss {a} with the "
                                     f"mesh, {b} without")
        err = max(float((one[0][k].detach() - one[1][k].detach()).abs()
                        .max()) for k in one[1])
        fp = (fingerprint(two[0]), fingerprint(two[1]))
        if not (err <= PAR_PARAM_TOL
                and abs(fp[0] - fp[1]) <= PAR_PARAM_TOL * max(1.0,
                                                              abs(fp[1]))):
            raise AssertionError(f"{label}: weights after one step differ "
                                 f"by {err}, sums after two {fp}")
        return err, fp

    try:
        # 1. NCCL (gloo on the CPU) at world size 1
        t0 = time.perf_counter()
        group = init_group("file://" + os.path.join(tmp, "store"), 1, 0,
                           dev)
        mesh = make_mesh() if dev == "cuda" else make_mesh(devices=[dev])
        if mesh.group is not group or mesh.devices[0].type != device.type:
            raise AssertionError(f"make_mesh() gave {mesh}")
        backend = dist.get_backend()
        print(f"parallel group: {backend} at world size "
              f"{dist.get_world_size()}, mesh {mesh.devices} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)

        # 2. LPSR at phase train's batch: two steps with and without the
        # mesh from the same weights and batches; then the step's time
        # with and without the all-reduce; validate through K2 float32
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(SEED)
        lr_b = [torch.rand((PAR_LPSR_BATCH, *LPSR_HW, 3), generator=g,
                           device=dev) for _ in range(2)]
        hr_b = [torch.rand((PAR_LPSR_BATCH, *LPSR_HW, 1), generator=g,
                           device=dev) for _ in range(2)]
        init, _ = load_state(CKPT_LPSR)
        sides, losses, one = {}, [], []
        for side, m in (("mesh", mesh), ("plain", None)):
            tr = LPSRTrainer(lpsr_cfg=LPSRConfig(), device=dev, mesh=m)
            st = tr.init(params=init)
            ls = []
            for i in range(2):
                st, loss = tr.step(st, lr_b[i], hr_b[i])
                ls.append(float(loss))
                if i == 0:
                    one.append({k: v.detach().clone()
                                for k, v in st["params"].items()})
            sides[side] = (tr, st)
            losses.append(ls)
        err, fp = compare("LPSR", list(zip(*losses)), one,
                          [sides[s][1]["params"] for s in ("mesh", "plain")])
        ms = {s: step_ms(lambda s=s: sides[s][0].step(sides[s][1], lr_b[0],
                                                      hr_b[0]),
                         PAR_TIMED_STEPS) for s in ("mesh", "plain")}
        counts_to_zero()
        val = [(lr_b[1][:LPSR_VAL_BATCH], hr_b[1][:LPSR_VAL_BATCH])]
        psnr = {s: sides[s][0].validate(sides[s][1], val)
                for s in ("mesh", "plain")}
        k2 = counts()["lpsr"]
        if dev == "cuda" and k2 != 2:
            raise AssertionError(f"LPSR validate launched K2 {k2} times, "
                                 f"not once a side")
        if abs(psnr["mesh"] - psnr["plain"]) > 1e-6:
            raise AssertionError(f"validate PSNR {psnr}")
        print(f"parallel LPSR trainer at batch {PAR_LPSR_BATCH}: losses "
              f"{losses[0]} with the mesh, {losses[1]} without; weights "
              f"after one step max_abs_err {err} (< {PAR_PARAM_TOL}), sums "
              f"after two {fp}; step {ms['mesh']:.3f} ms with the "
              f"all-reduce, {ms['plain']:.3f} ms without (median of "
              f"{PAR_TIMED_STEPS}); validate PSNR {psnr['mesh']} on both, "
              f"K2 float32 launches {k2} ({time.perf_counter() - t0:.2f} s)"
              f" on {card}", flush=True)
        note["lpsr step ms (mesh, plain)"] = (round(ms["mesh"], 3),
                                              round(ms["plain"], 3))
        del sides, one

        # 3. the detector at train_det's batch and size, past warm-up
        t0 = time.perf_counter()
        x, lab = bench_train_step.det_batch(PAR_DET_BATCH, hw=PAR_DET_HW,
                                            seed=SEED)
        x1, lab1 = bench_train_step.det_batch(PAR_DET_BATCH, hw=PAR_DET_HW,
                                              seed=SEED + 1)
        batches = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
                   for a, b in ((x, lab), (x1, lab1))]
        sides, losses, one = {}, [], []
        w0 = None
        for side, m in (("mesh", mesh), ("plain", None)):
            tr = YoloTrainer(yolov5("s", nc=bench_train_step.DET_NC),
                             YoloTrainConfig(epochs=10), steps_per_epoch=100,
                             mesh=m, device=dev)
            st = tr.init(torch.Generator().manual_seed(SEED), params=w0)
            if w0 is None:
                w0 = {k: v.detach().cpu().clone()
                      for k, v in st["params"].items()}
            st["step"] = DET_CMP_STEP
            ls = []
            for i in range(2):
                st, total, _ = tr.step(st, *batches[i])
                ls.append(float(total))
                if i == 0:
                    one.append({k: v.detach().clone()
                                for k, v in st["params"].items()})
            sides[side] = (tr, st)
            losses.append(ls)
        err, fp = compare("detector", list(zip(*losses)), one,
                          [sides[s][1]["params"] for s in ("mesh", "plain")])
        ms = {s: step_ms(lambda s=s: sides[s][0].step(sides[s][1],
                                                      *batches[0]),
                         PAR_TIMED_STEPS) for s in ("mesh", "plain")}
        if dev == "cuda":   # where the all-reduces' time goes
            for s in ("mesh", "plain"):
                prof = bench_train_step.profile_steps(
                    lambda s=s: sides[s][0].step(sides[s][1], *batches[0]),
                    device)
                print(f"parallel detector step profile, {s}: "
                      f"{json.dumps(prof)}", flush=True)
        print(f"parallel detector trainer (yolov5s nc="
              f"{bench_train_step.DET_NC}, {PAR_DET_HW[0]}x{PAR_DET_HW[1]}, "
              f"batch {PAR_DET_BATCH}, float32, step {DET_CMP_STEP}): "
              f"losses {losses[0]} with the mesh (global batch statistics "
              f"and positive count), {losses[1]} without; weights after one "
              f"step max_abs_err {err} (< {PAR_PARAM_TOL}), sums after two "
              f"{fp}; step {ms['mesh']:.3f} ms with the all-reduces, "
              f"{ms['plain']:.3f} ms without (median of {PAR_TIMED_STEPS})"
              f" ({time.perf_counter() - t0:.2f} s) on {card}", flush=True)
        note["det step ms (mesh, plain)"] = (round(ms["mesh"], 3),
                                             round(ms["plain"], 3))
        del sides, one, batches

        # 4. the recognizer with two replicas on the card
        t0 = time.perf_counter()
        frames = synth_frames(BATCH, FRAME_HW, SEED)
        dtype = torch.bfloat16 if dev == "cuda" else torch.float32
        recs, outs, launches, times = {}, {}, {}, {}
        for side, m in (("mesh", make_mesh(devices=[dev, dev])),
                        ("plain", None)):
            char, _, ck = load_char_ocr_npz(CKPT_CHAR, device=dev)
            r = PlateRecognizer(
                load_plate_detector(CKPT_PLATE, device=dev), char,
                load_lpsr(CKPT_LPSR, device=dev),
                PipelineConfig(det_hw=DET_HW, dtype=dtype),
                char_names=ck.names, device=dev, mesh=m)
            # the capture on the batch reversed, so that each replica's
            # replay below takes other frames than its graph was made on
            r.step_raw(np.ascontiguousarray(frames[::-1]))
            counts_to_zero()
            o = r.step_raw(frames)
            sync()
            launches[side] = counts()
            outs[side] = to_host(o)
            times[side] = step_ms(lambda r=r: r.step_raw(frames),
                                  PAR_TIMED_STEPS)
            recs[side] = r
        a, b = outs["mesh"], outs["plain"]
        texts = [[[(p["text"], p["text_sr"]) for p in f]
                  for f in recs[s].assemble(outs[s])] for s in outs]
        box_err = float(np.abs(a["plate_boxes"] - b["plate_boxes"])
                        [b["plate_valid"]].max(initial=0.0))
        if dev == "cuda" and (launches["mesh"]["yolo_front"] != 2
                              or launches["mesh"]["lpsr"] != 2):
            raise AssertionError(f"the two replicas launched "
                                 f"{launches['mesh']}")
        if not (np.array_equal(a["plate_valid"], b["plate_valid"])
                and np.array_equal(a["plate_classes"], b["plate_classes"])
                and box_err <= PAR_BOX_TOL and texts[0] == texts[1]
                and np.isfinite(a["sr"]).all()):
            raise AssertionError(f"the sharded recognizer differs: boxes "
                                 f"{box_err}, texts {texts}")
        print(f"parallel recognizer, 2 replicas on {dev} (batch {BATCH}, "
              f"{FRAME_HW[0]}p, det {DET_HW[0]}x{DET_HW[1]}, {dtype}, "
              f"frozen): "
              f"{int(b['plate_valid'].sum())} plates, valid, classes and "
              f"strings equal to the unsharded step's, boxes max_abs_err "
              f"{box_err} (< {PAR_BOX_TOL}); ms a batch {times['mesh']:.3f} "
              f"sharded, {times['plain']:.3f} unsharded (median of "
              f"{PAR_TIMED_STEPS}, host clock around synchronize); launches "
              f"a step sharded {launches['mesh']}, unsharded "
              f"{launches['plain']} ({time.perf_counter() - t0:.2f} s) on "
              f"{card}", flush=True)
        note["recognizer ms (2 replicas, 1)"] = (round(times["mesh"], 3),
                                                 round(times["plain"], 3))
        del recs

        # 5. autobatch: the chosen batch runs within its budget
        t0 = time.perf_counter()
        for model, hw in PAR_AUTOBATCH:
            rec = validate_autobatch.validate(
                model, hw, torch.bfloat16 if dev == "cuda"
                else torch.float32, [4, 16, 64], device)
            print(f"parallel autobatch {model} {hw}: {json.dumps(rec)}",
                  flush=True)
            if dev == "cuda" and not rec["fits"]:
                raise AssertionError(f"autobatch's batch {rec['autobatch']} "
                                     f"of {model} peaked at "
                                     f"{rec['chosen_peak_bytes']} over its "
                                     f"budget {rec['budget_bytes']}")
            note[f"autobatch {model}"] = rec.get("autobatch")
        print(f"parallel autobatch: {time.perf_counter() - t0:.2f} s",
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return note


def phase(name: str, t_start: float, note: str = "") -> None:
    print(f"phase {name}: ok {time.perf_counter() - t_start:.2f} s "
          f"(total {time.perf_counter() - _T0:.2f} s){note}", flush=True)


# G1's shapes: the served batches (closed cells 32, camera cells 16) and
# frame sizes (720p, and 1080p as the square deployment's frames), three
# plate slots.
G1_SHAPES = ((32, (720, 1280)), (32, (1080, 1920)), (16, (720, 1280)))
G1_GRAPH_CALLS = 20


def g1_row(card, timed):
    """G1 (kernels/crop_geometry.py) at the served shapes on frames of
    tools/synth.py with their panels' boxes (slots beyond a frame's
    panels zero): bf16 and float32 against the plain version in float32
    (crop_errors), then bf16 timed as CUDA graphs of repeated launches
    (plain, kernel, kernel, plain) beside its bound.  Returns its kernels
    entry, at the first shape."""
    import numpy as np
    import torch

    from lpr_tpu_torch.kernels import crop_geometry as kg
    from lpr_tpu_torch.tools import _timing
    from lpr_tpu_torch.tools.synth import synth_frames

    entry = None
    for batch, hw in G1_SHAPES:
        frames, labels = synth_frames(batch, hw, SEED, labels=True)
        boxes = np.zeros((batch, 3, 4), np.float32)
        for b, lab in enumerate(labels):
            cx, cy, w, h = (lab[:3, 1:] * [hw[1], hw[0], hw[1], hw[0]]).T
            boxes[b, :len(cx)] = np.stack([cx - w / 2, cy - h / 2,
                                           cx + w / 2, cy + h / 2], -1)
        x = torch.as_tensor(frames, device="cuda").to(torch.bfloat16) / 255.0
        bx = torch.as_tensor(boxes, device="cuda")
        errs = {}
        for dt in (torch.bfloat16, torch.float32):
            got = kg.plate_crops(x.to(dt), bx)
            torch.cuda.synchronize()
            errs[dt] = kg.crop_errors(got, x, bx)
            same, d_angle, n_band, d_crop = errs[dt]
            print(f"G1 plate_crops vs plate_crops_plain float32 "
                  f"({batch}, {hw[0]}, {hw[1]}, 3) "
                  f"{str(dt).replace('torch.', '')}: is_long equal {same}, "
                  f"angle err / {kg.TOL_ANGLE} {d_angle} (< 1) outside the "
                  f"ill-conditioned band ({n_band} of {batch * 3} slots in "
                  f"it), crops at G1's angle err / (abs {kg.TOL_ABS} + rel "
                  f"{kg.TOL_REL[dt]}) {d_crop} (< 1), {int(got[2].sum())} "
                  f"long", flush=True)
            if not (same and d_angle < 1 and d_crop < 1):
                raise AssertionError(f"G1 disagrees with its plain version "
                                     f"at {(batch, *hw)} {dt}")
        k_ms, plain_ms, runs = timed(
            lambda: kg.plate_crops(x, bx), lambda: kg.plate_crops_plain(x, bx),
            G1_GRAPH_CALLS, graphed=True)
        work = kg.crop_work(bx, hw)
        bound_ms, bound_by = _timing.bound_ms(work)
        print(f"G1 timing at ({batch}, {hw[0]}, {hw[1]}, 3), 3 slots, bf16 "
              f"on {card}: kernel {k_ms:.4f} ms, plain (the interpolation "
              f"matrices in bf16) {plain_ms:.4f} ms (runs plain, kernel, "
              f"kernel, plain {runs}), bound {bound_ms:.4f} ms ({bound_by}; "
              f"{work} FLOP, B)", flush=True)
        if entry is None:
            entry = {
                "name": "plate_crops", "route": "cuda",
                "source": "lpr_tpu_torch/csrc/crop_geometry.cu",
                "replaces": "none (lpr_tpu/ops/resample.py, no Pallas "
                            "kernel)",
                "launches": None, "max_abs_err": None,
                "err_over_tol": errs[torch.bfloat16][3], "ms": k_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
            }
    return entry


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
    from lpr_tpu_torch.kernels import crop_geometry as kg
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
    if sorted(libs) != ["conv_int8", "crop_geometry", "lpsr", "stamp",
                        "yolo_front", "yolo_mid"]:
        raise AssertionError(f"built {sorted(libs)}")
    smem = {n: getattr(libs[n].cdll, f"lpr_{n}_smem_bytes")() for n in libs
            if hasattr(libs[n].cdll, f"lpr_{n}_smem_bytes")}
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
    host_names = ["host_letterbox", "host_augment"] + (
        ["host_decode"] if not decode_missing else [])
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
        kg.plate_crops.launches = 0

    def counts():
        return {"yolo_front": kf.yolo_front.launches,
                "yolo_front_u8": kf.yolo_front.launches_u8,
                "lpsr": kl.lpsr_fused.launches,
                "yolo_mid": km.yolo_mid.launches,
                "act_amax": ki.act_amax.launches,
                "quantize_act": ki.quantize_act.launches,
                "conv_int8": ki.conv_int8.launches,
                "plate_crops": kg.plate_crops.launches}

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
    kernels.append(g1_row(card, timed))
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
        if c["plate_crops"] != 1:
            raise AssertionError(f"the {label} step launched G1 "
                                 f"{c['plate_crops']} times, not once")
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
    if min(serve_counts[k] for k in ("yolo_front", "lpsr",
                                     "plate_crops")) < 1:
        raise AssertionError(f"the server did not launch K1, K2 and G1: "
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

    # ---- 11. train -------------------------------------------------------
    t = time.perf_counter()
    train_note = train_phase(card, counts_to_zero, counts)
    phase("train", t, f"; {train_note} on {card}")

    # ---- 12. train_det ---------------------------------------------------
    t = time.perf_counter()
    train_det_note = train_det_phase(card)
    phase("train_det", t, f"; {train_det_note} on {card}")

    # ---- 13. parallel ----------------------------------------------------
    t = time.perf_counter()
    parallel_note = parallel_phase(card, counts_to_zero, counts)
    phase("parallel", t, f"; {parallel_note} on {card}")

    # ---- 14. serving -----------------------------------------------------
    from lpr_tpu_torch.tools import bench_serving

    t = time.perf_counter()
    brief = ["--clients", "16", "--frames", "4", "--max-batch", "8"]
    modes = [[], ["--pool"], ["--http"]] + ([] if decode_missing
                                            else [["--files"]])
    for m in modes:
        if bench_serving.main(brief + m) != 0:
            raise AssertionError(f"bench_serving {m}")
    phase("serving", t, f"; modes {[m or ['frames'] for m in modes]}")

    # ---- 15. bench -------------------------------------------------------
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
    by_name["plate_crops"]["launches"] = slice_counts["plate_crops"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
