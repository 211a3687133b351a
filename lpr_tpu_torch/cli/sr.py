"""Batch super-resolution CLI (counterpart of ``lpr_tpu/cli/sr.py``, the
reference ``inference/sr.py``): folder in -> folder out.

    python -m lpr_tpu_torch.cli.sr --weights best_model.npz \\
        --input-dir lr/ --output-dir sr/ [--model cyclegan] [--device cpu]

``--model lpsr`` runs the LPSR enhancer ([0, 1] in and out; on the card the
K2 kernel, float32); ``--model cyclegan`` runs a CycleGAN generator from
the reference's ``.pth`` state dict (or the repo's npz) with [-1, 1]
normalization, as the reference script does.  Inputs are resized with the
port's copy of Pillow's bicubic resample.  Outputs are PNG (the port has no
JPEG encoder): each keeps its input's file name, and a ``.jpg``/``.jpeg``
name gets ``.png`` appended.  Pixels are ``(out * 255).astype(uint8)``,
truncated as the JAX tool does, not rounded.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Batch plate SR")
    p.add_argument("--weights", required=True)
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--model", choices=["lpsr", "cyclegan"], default="lpsr")
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def output_name(name: str) -> str:
    """The output file's name: the input's, with ``.png`` appended where
    it does not already end in it."""
    return name if name.lower().endswith(".png") else name + ".png"


def build_model(kind: str, weights: str, device):
    """(forward on float32 NHWC tensors in [0, 1] -> [0, 1], on
    ``device``)."""
    if kind == "lpsr":
        from lpr_tpu_torch.kernels.lpsr import (lpsr_fused,
                                                lpsr_kernel_takes, lpsr_pack)
        from lpr_tpu_torch.models.lpsr import load_lpsr

        model = load_lpsr(weights, device=device)
        if not lpsr_kernel_takes(model.cfg):
            return model
        packed = lpsr_pack(model)
        return lambda x: lpsr_fused(x.contiguous(), packed)
    from lpr_tpu_torch.models.cyclegan import load_generator

    gen = load_generator(weights, device=device)
    return lambda x: gen(x * 2.0 - 1.0) * 0.5 + 0.5   # reference sr.py:35,58


def main(argv=None):
    args = parse_args(argv)
    import torch

    from lpr_tpu_torch import imageio, native
    from lpr_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    files = imageio.list_images(args.input_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    fn = build_model(args.model, args.weights, dev)
    written = []
    for s in range(0, len(files), args.batch):
        chunk = files[s:s + args.batch]
        imgs = [native.resize_pil_bicubic(
            imageio.read_rgb(os.path.join(args.input_dir, f)),
            (args.height, args.width)).astype(np.float32) / 255.0
            for f in chunk]
        with torch.inference_mode():
            y = fn(torch.from_numpy(np.stack(imgs)).to(dev))
            y = y.float().cpu().numpy()
        for f, out in zip(chunk, y):
            out = np.clip(out, 0, 1)
            if out.shape[-1] == 1:
                out = np.repeat(out, 3, -1)
            name = output_name(f)
            imageio.write_png(os.path.join(args.output_dir, name),
                              (out * 255).astype(np.uint8))
            written.append(name)
            if name != f:
                print(f"{f} -> {name} (PNG)")
        print(f"{min(s + args.batch, len(files))}/{len(files)}")
    return written


if __name__ == "__main__":
    main()
