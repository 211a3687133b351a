"""Where a recognizer step's time goes, stage by stage (counterpart of
``tools/profile_stages.py``).

    python -m lpr_tpu_torch.tools.profile_stages [--batch 8] [--calls 5]
        [--rounds 3] [--packed] [--int8] [--eager-decode] [--device cuda]

Builds the production recognizer (720p frames made with numpy by
``tools/synth.py``, detector at 736x1280, bf16, the repo's checkpoints; K1
and K2 on) and runs one step stage by stage through
``PlateRecognizer.step_raw``'s ``run`` hook, so each stage is measured on
the input the step itself gave it.  It then measures the whole step and
each stage in the order the step runs them
(``lpr_tpu_torch.pipeline.recognizer.STEP_STAGES``), and beside them the
detector through the plain layers and through K1 + K3, and the LPSR stage
through ``lpsr_plain``.  For each row:

- host ms/call: wall clock from a synchronize to a synchronize after
  ``--calls`` calls, best of ``--rounds`` rounds (all rounds printed);
- device-busy ms/call and launches/call: one ``torch.profiler`` window of
  ``--calls`` calls (the sum of kernel times; not measured on the CPU).

A stage whose host time is well above its device-busy time is bound by the
host issuing its kernels.  The sum of the stages and the step's
unaccounted rest close the table.  The step row is the step as the
recognizer runs it: one CUDA graph replay on a card (``freeze_params``,
the default), where the stages, each measured alone, are launched op by
op; :func:`eager_step_row` measures the whole step op by op beside it,
and :func:`frozen_rows` each stage again as the frozen step runs it: a
device stage captured alone as a CUDA graph and replayed, the upload as
the graph's pinned staging copy.  ``--packed`` runs it on host-letterboxed
frames (``packed_input``), whose "host letterbox" stage does its work on
the host; ``--int8`` with the detector in int8 (``int8_detector``: I1 and
I2 after K1), ``--eager-decode`` with the whole grid decoded before NMS
(``lazy_decode=False``).
Run from the repo root.
"""

from __future__ import annotations

import argparse
import functools
from typing import Callable, List, Tuple

import torch

from lpr_tpu_torch.tools import _timing

FRAME_HW = (720, 1280)
DET_HW = (736, 1280)

Stage = Tuple[str, Callable[[], object]]


def build_recognizer(device, dtype=torch.bfloat16, det_hw=DET_HW,
                     fused_mid=False, mesh=None, **cfg_kw):
    """The production recognizer on the repo's checkpoints, sharded over
    ``mesh`` where one is given; ``cfg_kw`` are further
    :class:`PipelineConfig` fields."""
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import (load_char_ocr_npz,
                                           load_plate_detector)
    from lpr_tpu_torch.pipeline.recognizer import (PipelineConfig,
                                                   PlateRecognizer)

    char, _, ck = load_char_ocr_npz("checkpoints/char_ocr_synth.npz", device)
    names = ck.names
    return PlateRecognizer(
        load_plate_detector("checkpoints/plate_det640.npz", device), char,
        load_lpsr("checkpoints/lpsr_synth_glare/best_model.npz",
                  device=device),
        PipelineConfig(det_hw=det_hw, dtype=dtype, fused_mid=fused_mid,
                       **cfg_kw),
        char_names=names, device=device, mesh=mesh)


def stage_split(rec, frames) -> Tuple[dict, List[Stage]]:
    """Runs one step stage by stage.  Returns step_raw's output and the
    stages as (name, thunk) in step order, where thunk() reruns the stage
    on the input it had in this step."""
    stages: List[Stage] = []

    def run(name, fn, *args):
        stages.append((name, functools.partial(fn, *args)))
        return fn(*args)

    return rec.step_raw(frames, run=run), stages


def alternatives(rec, stages: List[Stage]) -> List[Stage]:
    """The rows measured beside the step's own: the detector through the
    plain layers and through K1 + K3, and LPSR through its plain version,
    each on the input the step gave that stage."""
    from lpr_tpu_torch.kernels.lpsr import lpsr_plain
    from lpr_tpu_torch.kernels.yolo_mid import mid_pack

    args = {name: fn.args for name, fn in stages}
    lb, = args["plate detector"]
    packed = None
    if lb.dtype == torch.uint8:          # packed_input: the letterboxed bytes
        packed, lb = lb, lb.to(rec.cfg.dtype) / 255.0
    rows = [("plate detector, plain layers",
             functools.partial(rec.plate_model, lb))]
    if rec._front is not None:
        mid = rec._mid if rec._mid is not None else mid_pack(rec.plate_model)
        rows.append(("plate detector, K1 + K3", functools.partial(
            rec.plate_model, lb if packed is None else None,
            front=rec._front, mid=mid, packed=packed)))
    if rec._lpsr is not None:
        long_img, = args["LPSR"]
        sh, sw = rec.cfg.sr_hw
        sr_in = long_img.reshape(-1, sh, sw, 3).to(rec.cfg.dtype).contiguous()
        rows.append(("LPSR, lpsr_plain",
                     functools.partial(lpsr_plain, sr_in, rec._lpsr)))
    return rows


class Row:
    """One measured row: host ms per call (best and every round),
    device-busy ms, kernels executed and host launches per call (None
    where not measured)."""

    def __init__(self, name: str, host: List[float], win: _timing.Window):
        self.name = name
        self.host = host
        self.busy_ms = win.busy_ms
        self.launches = win.launches
        self.host_launches = win.host_launches

    @property
    def host_ms(self) -> float:
        return min(self.host)

    def line(self) -> str:
        return (f"{self.name:32s} {self.host_ms:9.3f} "
                f"{_timing.fmt(self.busy_ms):>12s} "
                f"{_timing.fmt(self.launches, '.1f'):>12s} "
                f"{_timing.fmt(self.host_launches, '.1f'):>12s}   "
                f"{[round(h, 3) for h in self.host]}")


def measure(name: str, fn: Callable[[], object], calls: int, rounds: int,
            device) -> Row:
    with torch.inference_mode():
        fn()
        host = [_timing.host_ms(fn, calls, device) for _ in range(rounds)]
        win = _timing.profile_window(fn, calls, device)
    return Row(name, host, win)


def split_rows(rec, frames, calls: int, rounds: int
               ) -> Tuple[Row, List[Row], List[Row]]:
    """(the whole step, its stages in step order, the alternatives)."""
    dev = rec.device
    for _ in range(2):
        rec.step_raw(frames)
    step = measure("step", functools.partial(rec.step_raw, frames), calls,
                   rounds, dev)
    _, stages = stage_split(rec, frames)
    rows = [measure(n, fn, calls, rounds, dev) for n, fn in stages]
    alt = [measure(n, fn, calls, rounds, dev)
           for n, fn in alternatives(rec, stages)]
    return step, rows, alt


def _graphed(fn: Callable[[], object], device) -> Callable[[], object]:
    """fn captured alone as a CUDA graph (after a warm-up on a side
    stream); returns the graph's replay."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.inference_mode():
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
    return graph.replay


def frozen_rows(rec, frames, stages: List[Stage], calls: int,
                rounds: int) -> List[Row]:
    """The stages as the frozen step runs them (card only; [] on the CPU):
    the host letterbox as it is, the upload as the captured step's pinned
    staging copies (``rec.step_raw`` has captured its graph for these
    frames), every device stage captured alone as a CUDA graph and
    measured by its replays."""
    if rec.device.type != "cuda":
        return []
    g = rec._graphs[tuple(int(n) for n in frames.shape)]
    rows = []
    for name, fn in stages:
        if name == "host letterbox":
            thunk = fn
        elif name == "upload":
            fr, pk = fn.args

            def thunk(fr=fr, pk=pk):
                g.frames.load(fr)
                if g.packed is not None:
                    g.packed.load(pk)
        else:
            thunk = _graphed(fn, rec.device)
        rows.append(measure(name, thunk, calls, rounds, rec.device))
    return rows


def eager_step_row(rec, frames, calls: int, rounds: int) -> Row:
    """The whole step launched op by op (``step_eager``), to set beside the
    step row where that is a graph replay."""
    return measure("step, eager", functools.partial(rec.step_eager, frames),
                   calls, rounds, rec.device)


def report(step: Row, rows: List[Row], alt: List[Row]) -> List[str]:
    """The table's lines."""
    head = (f"{'stage':32s} {'host ms':>9s} {'device ms':>12s} "
            f"{'launches':>12s} {'host calls':>12s}   host ms of each round")
    lines = [head, step.line()]
    lines += ["  " + r.line() for r in rows]

    def total(key):
        vals = [getattr(r, key) for r in rows]
        return None if None in vals else sum(vals)

    host_sum, busy_sum, n_sum = (total("host_ms"), total("busy_ms"),
                                 total("launches"))
    lines.append(f"{'sum of stages':32s} {host_sum:9.3f} "
                 f"{_timing.fmt(busy_sum):>12s} "
                 f"{_timing.fmt(n_sum, '.1f'):>12s}")

    def rest(a, b):
        return None if a is None or b is None else a - b

    lines.append(f"{'unaccounted (step - sum)':32s} "
                 f"{step.host_ms - host_sum:9.3f} "
                 f"{_timing.fmt(rest(step.busy_ms, busy_sum)):>12s} "
                 f"{_timing.fmt(rest(step.launches, n_sum), '.1f'):>12s}")
    lines.append("beside the step (not in the sum):")
    lines += ["  " + r.line() for r in alt]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=FRAME_HW)
    ap.add_argument("--det-hw", type=int, nargs=2, default=DET_HW)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--packed", action="store_true",
                    help="packed_input: host-letterboxed uint8 frames")
    ap.add_argument("--int8", action="store_true",
                    help="int8_detector: I1 + I2 after K1")
    ap.add_argument("--eager-decode", action="store_true",
                    help="lazy_decode=False: the whole grid decoded")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.tools.synth import synth_frames

    dev = resolve_device(args.device)
    rec = build_recognizer(dev, getattr(torch, args.dtype),
                           tuple(args.det_hw), packed_input=args.packed,
                           int8_detector=args.int8,
                           lazy_decode=not args.eager_decode)
    frames = synth_frames(args.batch, tuple(args.frame_hw), seed=0)
    step, rows, alt = split_rows(rec, frames, args.calls, args.rounds)
    alt.insert(0, eager_step_row(rec, frames, args.calls, args.rounds))
    frozen = frozen_rows(rec, frames, stage_split(rec, frames)[1],
                         args.calls, args.rounds)
    print(f"card: {_timing.card(dev)}")
    print(f"step by stage: batch {args.batch}, frames "
          f"{args.frame_hw[0]}x{args.frame_hw[1]}, det "
          f"{args.det_hw[0]}x{args.det_hw[1]}, {args.dtype}"
          f"{', packed input' if args.packed else ''}"
          f"{', int8 detector' if args.int8 else ''}"
          f"{', eager decode' if args.eager_decode else ''}; step "
          f"{'frozen' if dev.type == 'cuda' else 'eager'}; "
          f"launches = kernels executed, host calls = launches issued; "
          f"per call, "
          f"best of {args.rounds} rounds of {args.calls} calls; "
          f"{1e3 * args.batch / step.host_ms:.3f} frames/s at the best step")
    for line in report(step, rows, alt):
        print(line)
    if frozen:
        print("the stages as the frozen step runs them (each device stage "
              "captured alone as a CUDA graph; the upload through pinned "
              "staging):")
        print("\n".join("  " + r.line() for r in frozen))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
