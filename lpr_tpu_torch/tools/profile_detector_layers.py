"""Where the plate detector's time goes, layer by layer (counterpart of
``tools/profile_detector_layers.py``).

    python -m lpr_tpu_torch.tools.profile_detector_layers [--plain]
        [--no-mid] [--batch 8] [--calls 5] [--rounds 3] [--device cuda]

Times the cumulative prefixes [0..k] of the yolov5s plate detector
(``checkpoints/plate_det640.npz``, bf16) on a (batch, 736, 1280, 3) input
made from a seed, from k = 2 to the Detect layer, so that successive
differences give each layer's cost.  By default layers 0-2 run as K1 and
layers 3-4 as K3; ``--no-mid`` runs K1 only, ``--plain`` neither (the JAX
tool's ``--xla``).  Per prefix: host ms/call (best of the rounds, from a
synchronize to a synchronize), device-busy ms and launches per call (one
``torch.profiler`` window), and the increase over the previous prefix.
Run from the repo root.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from lpr_tpu_torch.tools import _timing

DET_HW = (736, 1280)


def prefix_forward(model, x, upto: int, front=None, mid=None):
    """Layers [0, upto] of a :class:`~lpr_tpu_torch.models.yolo.YoloModel`
    on ``x`` (the counterpart of ``prefix_apply``): layers 0-2 as K1 with
    ``front``, and 3-4 as K3 with ``mid`` as well, as ``forward`` runs them.
    At the Detect index it is ``model(x, front=front, mid=mid)``."""
    from lpr_tpu_torch.kernels.yolo_front import yolo_front
    from lpr_tpu_torch.kernels.yolo_mid import yolo_mid

    if front is None:
        if mid is not None:
            raise ValueError("the fused mid runs on the fused front's "
                             "output: pass front as well")
        return model.forward_from(x, 0, upto + 1)
    y = yolo_front(x, front)
    if upto < 3:
        return y
    if mid is None:
        return model.forward_from(y, 3, upto + 1)
    y = yolo_mid(y, mid)
    if upto < 5:
        return y
    return model.forward_from(y, 5, upto + 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plain", action="store_true",
                    help="no K1 or K3: every layer through PyTorch")
    ap.add_argument("--no-mid", action="store_true", help="K1 only")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--det-hw", type=int, nargs=2, default=DET_HW)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.kernels.yolo_front import front_pack
    from lpr_tpu_torch.kernels.yolo_mid import mid_pack
    from lpr_tpu_torch.models.yolo import Detect, load_plate_detector

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    model = load_plate_detector("checkpoints/plate_det640.npz", dev).to(dtype)
    front = None if args.plain else front_pack(model)
    mid = None if (args.plain or args.no_mid) else mid_pack(model)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch, *args.det_hw, 3).astype(np.float32)).to(dev, dtype)
    det_i = next(i for i, l in enumerate(model.layers)
                 if isinstance(l, Detect))
    print(f"card: {_timing.card(dev)}")
    print(f"plate detector by layer: batch {args.batch}, det "
          f"{args.det_hw[0]}x{args.det_hw[1]}, {args.dtype}; K1 "
          f"{'off' if front is None else 'on'}, K3 "
          f"{'off' if mid is None else 'on'}; per call, best of "
          f"{args.rounds} rounds of {args.calls} calls")
    print(f"{'prefix':30s} {'host ms':>9s} {'(+layer)':>9s} "
          f"{'device ms':>12s} {'(+layer)':>12s} {'launches':>9s}")
    prev_host, prev_busy = 0.0, 0.0
    with torch.inference_mode():
        for upto in range(2, det_i + 1):
            layer = model.layers[upto]
            fn = functools.partial(prefix_forward, model, x, upto, front, mid)
            fn()
            host = min(_timing.host_ms(fn, args.calls, dev)
                       for _ in range(args.rounds))
            win = _timing.profile_window(fn, args.calls, dev)
            busy = win.busy_ms
            d_busy = None if busy is None else busy - prev_busy
            print(f"[0..{upto:2d}] {type(layer).__name__:10s} "
                  f"{getattr(layer, 'c2', ''):>10} {host:9.3f} "
                  f"{host - prev_host:+9.3f} {_timing.fmt(busy):>12s} "
                  f"{_timing.fmt(d_busy, '+.3f'):>12s} "
                  f"{_timing.fmt(win.launches, '.0f'):>9s}")
            prev_host, prev_busy = host, busy or 0.0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
