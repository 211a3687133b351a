"""Accuracy evaluation CLI (counterpart of ``lpr_tpu/cli/evaluate.py``, the
reference ``evaluation/eval.py``): a folder of plate crops, ground truth
the filename stem uppercased; reports full-plate accuracy and CER with and
without SR.

    python -m lpr_tpu_torch.cli.evaluate --eval-folder plates/ \\
        --sr-weights checkpoints/lpsr_synth_glare/best_model.npz \\
        --ocr-weights checkpoints/char_ocr_synth.npz [--device cpu]

The char OCR loads from the repo's npz checkpoint or the reference's
``char.pt``; LPSR from npz, the reference's ``.pth`` state dict or an
``.onnx`` graph.  On the card LPSR runs the K2 kernel.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SR-for-OCR evaluation")
    p.add_argument("--eval-folder", required=True)
    p.add_argument("--sr-weights", required=True)
    p.add_argument("--ocr-weights", required=True)
    p.add_argument("--ocr-conf", type=float, default=0.5)
    p.add_argument("--iou", type=float, default=0.3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--json-out", type=str, default=None)
    p.add_argument("--per-image", action="store_true",
                   help="include per-image gt/raw/sr strings in --json-out "
                        "(the error-distribution analyses need them)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_evaluator(ocr_weights: str, sr_weights: str, device: str,
                    **kw):
    """The char OCR (npz or the reference's .pt) and LPSR (npz, .pth or
    .onnx) in an :class:`~lpr_tpu_torch.eval.harness.OcrEvaluator` on
    ``device``."""
    from lpr_tpu_torch.eval.harness import OcrEvaluator
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import load_char_ocr

    model, _, ck = load_char_ocr(ocr_weights, device=device)
    names = ck.names
    lpsr = load_lpsr(sr_weights, device=device)
    return OcrEvaluator(model, lpsr, names=names, device=device, **kw)


def report_json(rep, per_image: bool) -> dict:
    out = {"n": rep.n, "acc_raw": rep.acc_raw, "acc_sr": rep.acc_sr,
           "cer_raw": rep.cer_raw, "cer_sr": rep.cer_sr}
    if per_image:
        out["per_image"] = rep.per_image
    return out


def main(argv=None):
    args = parse_args(argv)
    ev = build_evaluator(args.ocr_weights, args.sr_weights, args.device,
                         ocr_conf=args.ocr_conf, iou=args.iou)
    rep = ev.evaluate_folder(args.eval_folder, batch_size=args.batch)
    if args.verbose:
        for r in rep.per_image:
            print(f"GT {r['gt']:<12} raw {r['raw']:<12} sr {r['sr']}")
    print("--- SR Model Evaluation Report ---")
    print(f"Total images evaluated: {rep.n}")
    print(f"Without SR: accuracy {rep.acc_raw*100:.2f}%  CER {rep.cer_raw*100:.2f}%")
    print(f"With SR:    accuracy {rep.acc_sr*100:.2f}%  CER {rep.cer_sr*100:.2f}%")
    print(f"Improvement: {(rep.acc_sr-rep.acc_raw)*100:+.2f} pts accuracy, "
          f"{(rep.cer_sr-rep.cer_raw)*100:+.2f} pts CER")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report_json(rep, args.per_image), f)
    return rep


if __name__ == "__main__":
    main()
