"""Model export CLI (counterpart of ``lpr_tpu/cli/export.py``, itself the
counterpart of the reference's ``my_utils/export_onnx.py``).

    python -m lpr_tpu_torch.cli.export --model-type sr \\
        --weights checkpoints/lpsr_synth_glare/best_model.npz \\
        --output build/sr.onnx

Formats (``--format``, by default from the output's extension):

- ``onnx``: the dependency-free ONNX emit with the reference's serving
  contract, sr (input_image/output_image, dynamic batch/H/W) and
  detection/ocr (input_image/predictions, decode included, NMS excluded,
  dynamic batch), :mod:`lpr_tpu_torch.weights.onnx_export`;
- ``pt2``: a ``torch.export`` program of any of the three models on
  ``--device`` (:mod:`lpr_tpu_torch.weights.export_program`), where the
  JAX CLI writes ``stablehlo``, which the port refuses;
- ``torch`` (sr only): the reference-loadable ``.pth`` state dict;
- ``npz``: the flat checkpoint.

sr weights may be ``.npz``, ``.pth``/``.pt`` or ``.onnx``
(:func:`~lpr_tpu_torch.models.lpsr.lpsr_state`); detection and ocr weights
are a YOLOv5 ``.pt`` (:func:`~lpr_tpu_torch.models.yolo.load_yolo_torch`),
as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FORMATS = ["onnx", "pt2", "torch", "npz"]
DEFAULT_HW = {"sr": (32, 192), "detection": (1280, 1280), "ocr": (128, 128)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export models (PyTorch port)")
    p.add_argument("--model-type", required=True,
                   choices=["sr", "detection", "ocr"])
    p.add_argument("--weights", required=True,
                   help="sr: .npz/.pth/.pt/.onnx; detection, ocr: .pt")
    p.add_argument("--output", required=True, help="output artifact path")
    p.add_argument("--format", default=None,
                   choices=FORMATS + ["stablehlo"],
                   help="default: from the output extension (.onnx, .pt2, "
                        ".pth/.pt, .npz)")
    p.add_argument("--size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="input size for onnx (detection, ocr) and pt2 "
                        "(defaults: sr 32x192, detection 1280x1280, ocr "
                        "128x128)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    fmt = args.format
    if fmt is None:
        ext = os.path.splitext(args.output)[1].lower()
        fmt = {".onnx": "onnx", ".pth": "torch", ".pt": "torch",
               ".npz": "npz"}.get(ext, "pt2")
    if fmt == "stablehlo":
        raise SystemExit("--format stablehlo is the JAX package's artifact; "
                         "the port exports torch.export programs: use "
                         "--format pt2")
    out_dir = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(out_dir, exist_ok=True)
    hw = tuple(args.size) if args.size else DEFAULT_HW[args.model_type]

    if args.model_type == "sr":
        from lpr_tpu_torch.models.lpsr import LPSRConfig, lpsr_state

        cfg = LPSRConfig()
        state = lpsr_state(args.weights, cfg)
        if fmt == "onnx":
            from lpr_tpu_torch.weights.onnx_export import export_lpsr_onnx

            export_lpsr_onnx(state, args.output, cfg)
        elif fmt == "torch":
            from lpr_tpu_torch.weights.export_torch import save_lpsr_torch

            save_lpsr_torch(args.output, state, cfg)
        elif fmt == "npz":
            np.savez_compressed(args.output, **state)
        else:
            from lpr_tpu_torch.weights.export_program import export_lpsr

            export_lpsr(state, args.output, batch=1, hw=hw, cfg=cfg,
                        device=args.device)
    else:  # detection / ocr: the YOLO family
        from lpr_tpu_torch.models.yolo import load_yolo_torch

        if fmt == "torch":
            raise SystemExit("torch re-export covers the sr model only")
        model, state, _ = load_yolo_torch(args.weights, device=args.device)
        if fmt == "onnx":
            from lpr_tpu_torch.weights.onnx_export import export_yolo_onnx

            export_yolo_onnx(model, state, args.output, hw=hw)
        elif fmt == "npz":
            np.savez_compressed(args.output, **state)
        else:
            from lpr_tpu_torch.weights.export_program import export_detector

            export_detector(model, args.output, batch=1, hw=hw)
    print(f"exported {args.model_type} ({fmt}) -> {args.output}")


if __name__ == "__main__":
    main()
