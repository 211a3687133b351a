"""The detector, LPSR and char OCR convolution shapes through cuDNN
(counterpart of ``tools/bench_convs.py``): the per-layer library
yardsticks for the hand-written kernels.

    python -m lpr_tpu_torch.tools.bench_convs [--batch 32] [--iters 20]
        [--rounds 3] [--div 1] [--device cuda]

Each distinct convolution shape of yolov5s at 736x1280, the LPSR and the
char OCR (the JAX tool's list; its C3TR attention row is skipped there
too) runs as one ``F.conv2d`` in bf16 on channels-last tensors, padding
k // 2, timed with CUDA events (mean of ``--iters`` calls, best of
``--rounds``).  Prints ms, TFLOP/s and the share of the H100's dense bf16
peak (989 TFLOP/s).  ``--div`` divides every height and width, for a
quick run at a small size.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from lpr_tpu_torch.tools import _timing


def cases(batch: int):
    """(name, H, W, Cin, Cout, k, stride, batch), as the JAX tool's list
    (its batch 32 is ``batch`` here); H == 0 marks a skipped row."""
    B = batch
    return [
        ("stem S2D 12->32 @368x640", 368, 640, 12, 32, 3, 1, B),
        ("down 32->64 s2 @368x640", 368, 640, 32, 64, 3, 2, B),
        ("C3 b1 32->32 @184x320", 184, 320, 32, 32, 1, 1, B),
        ("C3 b3 32->32 @184x320 k3", 184, 320, 32, 32, 3, 1, B),
        ("down 64->128 s2 @184x320", 184, 320, 64, 128, 3, 2, B),
        ("C3 64->64 @92x160 k3", 92, 160, 64, 64, 3, 1, B),
        ("down 128->256 s2 @92x160", 92, 160, 128, 256, 3, 2, B),
        ("C3 128->128 @46x80 k3", 46, 80, 128, 128, 3, 1, B),
        ("down 256->512 s2 @46x80", 46, 80, 256, 512, 3, 2, B),
        ("C3 256->256 @23x40 k3", 23, 40, 256, 256, 3, 1, B),
        ("det head 128->48 1x1 @92x160", 92, 160, 128, 48, 1, 1, B),
        # LPSR inner shapes (3 crops per frame of 32x192, f=32, g=16)
        ("lpsr rdb 32->16 k3 @32x192", 32, 192, 32, 16, 3, 1, 3 * B),
        ("lpsr rdb 80->32 1x1 @32x192", 32, 192, 80, 32, 1, 1, 3 * B),
        ("lpsr ae dconv dw5x5 @16x96", 16, 96, 48, 48, 5, 1, 3 * B),
        # char OCR inner shapes (6 canvases per frame of 128x128)
        ("char C3 32->32 k3 @32x32", 32, 32, 32, 32, 3, 1, 6 * B),
        ("char C3TR qkv 256 tok", 0, 0, 0, 0, 0, 0, 0),  # skipped
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--div", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cudnn.benchmark = True
    rng = np.random.RandomState(0)
    print(f"card: {_timing.card(dev)}")
    print(f"bf16 F.conv2d, channels-last, batch {args.batch}; mean of "
          f"{args.iters} calls, best of {args.rounds} rounds; share of "
          f"{_timing.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s")
    for name, H, W, Ci, Co, k, s, batch in cases(args.batch):
        if H == 0:
            print(f"{name:34s} skipped")
            continue
        H, W = max(H // args.div, k), max(W // args.div, k)
        x = torch.from_numpy(rng.rand(batch, Ci, H, W).astype(np.float32)
                             ).to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w = torch.from_numpy(rng.rand(Co, Ci, k, k).astype(np.float32)
                             * 0.01).to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            ms = min(_timing.event_ms(
                lambda: F.conv2d(x, w, stride=s, padding=k // 2),
                args.iters, dev) for _ in range(args.rounds))
        flops = 2 * batch * (H // s) * (W // s) * Ci * Co * k * k
        tf = flops / (ms * 1e-3) / 1e12
        share = (f"{100 * tf * 1e12 / _timing.PEAK_BF16_FLOPS:4.1f}% peak"
                 if dev.type == "cuda" else "host clock, no peak share")
        print(f"{name:34s} {ms:8.4f} ms  {tf:7.1f} TF/s ({share})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
