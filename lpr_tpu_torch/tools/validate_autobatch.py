"""Check autobatch's memory estimate against what the card allocates
(counterpart of ``tools/validate_autobatch.py``, which reads XLA's
``memory_analysis()``; the reference's probe is CUDA memory,
``yolov5/utils/autobatch.py:16-57``).

    python -m lpr_tpu_torch.tools.validate_autobatch [--model det|lpsr]
        [--imgsz 640 | --imgsz H W] [--dtype f32|bf16] [--train]
        [--batches 4 16 64] [--device cpu]

The estimate is :func:`lpr_tpu_torch.utils.autobatch.traced_bytes` at
batch 1 (peak live bytes + output bytes, on meta tensors).  The truth is
``torch.cuda.max_memory_allocated()`` above the weights during one call at
each batch (the input counted, allocated after the baseline), and its
marginal bytes per sample (the slope between the two largest batches),
which is what a batch size spends.  ``--train`` measures the detector's
training step (forward, loss and gradients of ``YoloTrainer.grads``, the
use the reference's AutoBatch serves).  The line reports the ratio of the
marginal to the estimate (autobatch's ``layout_factor`` must be at least
it), the batch :func:`autobatch` picks for the card, and that batch's
measured peak against its budget, beside the card's name and power limit.
On the CPU it prints the estimate only ("not measured" for the rest).

Models: ``det`` is the plate detector, yolov5s nc=11 (random weights,
the forward through the plain layers, raw head); ``lpsr`` the production
LPSR (``LPSR.forward``; sample 32x192 by default).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Tuple

import torch

from lpr_tpu_torch.tools._timing import card
from lpr_tpu_torch.utils.autobatch import (LAYOUT_FACTOR, autobatch,
                                           traced_bytes)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _forward(module, x):
    return module(x)


def build(model: str, dtype: torch.dtype, device: torch.device):
    """(module, sample shape for ``--imgsz`` None)."""
    if model == "lpsr":
        from lpr_tpu_torch.models.lpsr import LPSR, LPSRConfig, lpsr_init

        cfg = LPSRConfig()
        m = LPSR(lpsr_init(torch.Generator().manual_seed(0), cfg), cfg)
        return m.to(device, dtype).eval(), (32, 192, 3)
    from lpr_tpu_torch.models.yolo import yolov5
    from lpr_tpu_torch.models.yolo_train import yolo_init

    m = yolov5("s", nc=11)
    m.load_state(yolo_init(m))
    return m.to(device, dtype).eval(), (640, 640, 3)


def train_step(device: torch.device, dtype: torch.dtype):
    """(step(x, labels) on the trainer's leaves, the leaves, labels of a
    batch): ``YoloTrainer.grads`` of yolov5s nc=11."""
    from lpr_tpu_torch.train.yolo import YoloTrainConfig, YoloTrainer
    from lpr_tpu_torch.models.yolo import yolov5

    tr = YoloTrainer(yolov5("s", nc=11), YoloTrainConfig(compute_dtype=dtype),
                     device=device)
    params = tr.init()["params"]

    def labels(b: int, dev) -> torch.Tensor:
        lab = torch.zeros((b, 16, 5), device=dev)
        lab[:, :3] = torch.tensor([7.0, 0.5, 0.5, 0.2, 0.1], device=dev)
        return lab

    anchors = tr.anchors

    def step(p, x, lab):
        tr.anchors = (anchors if x.device == anchors.device
                      else torch.empty_like(anchors, device=x.device))
        return tr.grads(p, x, lab)[1]

    return step, params, labels


def measured_bytes(fn: Callable[[torch.Tensor], object], make_x,
                   device: torch.device) -> int:
    """max_memory_allocated above the baseline during one ``fn(x)``, the
    input made after the baseline."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    x = make_x()
    out = fn(x)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del x, out
    return peak


def validate(model: str, hw: Optional[Tuple[int, int]], dtype: torch.dtype,
             batches: List[int], device: torch.device,
             train: bool = False) -> Dict[str, object]:
    """The JSON record of the module docstring."""
    m, sample = build(model, dtype, device)
    if hw is not None:
        sample = (*hw, sample[-1])
    rec: Dict[str, object] = {"model": model, "sample": list(sample),
                              "dtype": str(dtype), "train": train}
    if train:
        step, params, labels = train_step(device, dtype)
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                .requires_grad_(v.requires_grad) for k, v in params.items()}
        peak1, out1 = traced_bytes(
            lambda x, lab: step(meta, x, lab),
            torch.empty((1, *sample), dtype=dtype),
            labels(1, "cpu"))

        def run(b):
            return measured_bytes(
                lambda x: step(params, x, labels(b, device)),
                lambda: torch.rand((b, *sample), device=device).to(dtype),
                device)
    else:
        from torch.func import functional_call

        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in m.state_dict().items()}
        with torch.no_grad():
            peak1, out1 = traced_bytes(
                lambda x: functional_call(m, meta, (x,)),
                torch.empty((1, *sample), dtype=dtype))

        def run(b):
            with torch.no_grad():
                return measured_bytes(
                    lambda x: m(x),
                    lambda: torch.rand((b, *sample),
                                       device=device).to(dtype), device)
    est = peak1 + out1
    rec.update({"estimate_bytes_per_sample": est, "peak1": peak1,
                "out1": out1, "device": card(device)})
    if device.type != "cuda":
        rec.update({"measured": "not measured (no card)",
                    "marginal_bytes_per_sample": None, "ratio": None})
        return rec
    got = {b: run(b) for b in batches}
    lo, hi = sorted(got)[-2:]
    slope = (got[hi] - got[lo]) / (hi - lo)
    rec.update({"measured_bytes": {str(b): v for b, v in got.items()},
                "marginal_bytes_per_sample": slope, "ratio": slope / est,
                "layout_factor": LAYOUT_FACTOR})
    if not train:
        total = torch.cuda.get_device_properties(device).total_memory
        chosen = autobatch(_forward, m, sample, dtype)
        param_bytes = sum(t.numel() * t.element_size()
                          for t in m.state_dict().values())
        budget = total * (1 - 0.35) - 2 * param_bytes
        peak = run(chosen)
        rec.update({"autobatch": chosen, "chosen_peak_bytes": peak,
                    "budget_bytes": budget, "fits": peak <= budget})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="det", choices=["det", "lpsr"])
    ap.add_argument("--imgsz", type=int, nargs="+", default=None,
                    help="square size or H W (det default 640, lpsr 32 192)")
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES))
    ap.add_argument("--train", action="store_true",
                    help="the detector's training step instead of the "
                         "forward")
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from lpr_tpu_torch.device import resolve_device

    if args.train and args.model != "det":
        raise SystemExit("--train measures the detector's step")
    if len(args.batches) < 2:
        raise SystemExit("--batches takes two sizes at least")
    hw = None
    if args.imgsz is not None:
        hw = (tuple(args.imgsz * 2)[:2] if len(args.imgsz) == 1
              else tuple(args.imgsz))
    torch.backends.cudnn.allow_tf32 = False
    rec = validate(args.model, hw, DTYPES[args.dtype], args.batches,
                   resolve_device(args.device), args.train)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
