"""The LPSR and char OCR convolutions through cuDNN, shape by shape and as
whole forwards (counterpart of ``tools/bench_sr_convs.py``): the library
yardsticks for K2.

    python -m lpr_tpu_torch.tools.bench_sr_convs [--n 24] [--iters 20]
        [--rounds 3] [--div 1] [--device cuda]

Rows, each in bf16 on channels-last tensors, timed with CUDA events (mean
of ``--iters`` calls, best of ``--rounds``), with ms, GFLOP, TFLOP/s and
the share of the H100's dense bf16 peak (989 TFLOP/s):

- ``LPSR.forward`` on n 32x192 crops with the repo's LPSR weights
  (``checkpoints/lpsr_synth_glare/best_model.npz``): the composed library
  yardstick for K2 (many cuDNN calls and elementwise kernels, not one
  call); its operations are :func:`~lpr_tpu_torch.kernels.lpsr.lpsr_work`'s;
- the char OCR forward on 2n 128x128 canvases with
  ``checkpoints/char_ocr_synth.npz``;
- the JAX tool's convolution shapes at batch n (char shapes at 2n): the
  RDB dense 3x3 32/48/64/80 -> 16, the CSAR 3x3 32 -> 32, shallowF1 7x7
  3 -> 32, lff 1x1 96 -> 32 at 32x192; the char stem 3x3 12 -> 16 at 64x64
  and a C3 3x3 32 -> 32 at 32x32;
- one RDB (4 dense layers + lff) as the model composes it.

The forwards' operations come from ``torch.utils.flop_counter`` except
LPSR's.  ``--div`` divides every height and width, for a quick run at a
small size; ``--device cpu`` times with the host clock.
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from lpr_tpu_torch.tools import _timing

CKPT_LPSR = "checkpoints/lpsr_synth_glare/best_model.npz"
CKPT_CHAR = "checkpoints/char_ocr_synth.npz"


def conv_cases(n: int):
    """(name, batch, H, W, Cin, Cout, k): the JAX tool's shape list."""
    return [
        ("dense 3x3  32->16", n, 32, 192, 32, 16, 3),
        ("dense 3x3  48->16", n, 32, 192, 48, 16, 3),
        ("dense 3x3  64->16", n, 32, 192, 64, 16, 3),
        ("dense 3x3  80->16", n, 32, 192, 80, 16, 3),
        ("csar  3x3  32->32", n, 32, 192, 32, 32, 3),
        ("sfe1  7x7   3->32", n, 32, 192, 3, 32, 7),
        ("lff   1x1  96->32", n, 32, 192, 96, 32, 1),
        ("char stem 12->16 (64^2)", 2 * n, 64, 64, 12, 16, 3),
        ("char c3   32->32 (32^2)", 2 * n, 32, 32, 32, 32, 3),
    ]


def best_ms(fn: Callable[[], object], iters: int, rounds: int,
            device: torch.device) -> float:
    """Best of ``rounds`` means of ``iters`` calls (CUDA events on a card,
    the host clock on the CPU)."""
    with torch.inference_mode():
        return min(_timing.event_ms(fn, iters, device)
                   for _ in range(rounds))


def lpsr_forward_ms(model, x: torch.Tensor, iters: int, rounds: int = 1
                    ) -> float:
    """ms of ``model(x)``: an LPSR forward in x's dtype, composed of the
    library's calls (the yardstick beside K2)."""
    return best_ms(lambda: model(x), iters, rounds, x.device)


def _flops(fn: Callable[[], object]) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _row(name: str, ms: float, flops: float, dev: torch.device) -> str:
    tf = flops / (ms * 1e-3) / 1e12
    share = (f"{100 * tf * 1e12 / _timing.PEAK_BF16_FLOPS:4.1f}% peak"
             if dev.type == "cuda" else "host clock, no peak share")
    return (f"{name:40s} {ms:9.4f} ms {flops / 1e9:8.3f} GF "
            f"{tf:7.2f} TF/s ({share})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--div", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.kernels.lpsr import lpsr_work
    from lpr_tpu_torch.models.lpsr import load_lpsr
    from lpr_tpu_torch.models.yolo import load_char_ocr_npz

    dev = resolve_device(args.device)
    torch.backends.cudnn.benchmark = True
    rng = np.random.RandomState(0)
    n, d = args.n, args.div
    bf = torch.bfloat16

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)
                                ).to(dev, bf)

    print(f"card: {_timing.card(dev)}")
    print(f"bf16, batch n = {n}, heights and widths / {d}; mean of "
          f"{args.iters} calls, best of {args.rounds} rounds; share of "
          f"{_timing.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s")
    lpsr = load_lpsr(CKPT_LPSR, device=dev).to(bf)
    h, w = 32 // d, 192 // d
    crops = rand(n, h, w, 3)
    ms = lpsr_forward_ms(lpsr, crops, args.iters, args.rounds)
    print(_row(f"LPSR.forward ({n} crops, {h}x{w}, composed)", ms,
               lpsr_work(n, h, w)[0], dev))

    char, _, _ = load_char_ocr_npz(CKPT_CHAR, device=dev)
    char = char.to(bf)
    c = 128 // d
    canvases = rand(2 * n, c, c, 3)
    ms = best_ms(lambda: char(canvases), args.iters, args.rounds, dev)
    print(_row(f"char OCR forward ({2 * n} canvases, {c}^2)", ms,
               _flops(lambda: char(canvases)), dev))

    for name, b, hh, ww, ci, co, k in conv_cases(n):
        hh, ww = max(hh // d, k), max(ww // d, k)
        x = rand(b, ci, hh, ww).contiguous(memory_format=torch.channels_last)
        wt = (rand(co, ci, k, k) * 0.1).contiguous(
            memory_format=torch.channels_last)
        ms = best_ms(lambda: F.conv2d(x, wt, padding=k // 2), args.iters,
                     args.rounds, dev)
        print(_row(f"{name} @{hh}x{ww}", ms, 2 * b * hh * ww * ci * co * k * k,
                   dev))

    rdb = lpsr.rdbs[0]
    z = rand(n, h, w, 32)
    ms = best_ms(lambda: rdb(z), args.iters, args.rounds, dev)
    print(_row("one RDB (4 dense + lff, composed)", ms,
               _flops(lambda: rdb(z)), dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
