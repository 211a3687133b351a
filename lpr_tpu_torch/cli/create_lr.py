"""LR training-data generator (counterpart of ``lpr_tpu/cli/create_lr.py``,
reference ``my_utils/create_lr.py:45-90``).

    python -m lpr_tpu_torch.cli.create_lr --hr-dir hr/ --out-dir lr/ \\
        [--gan-weights checkpoints/cyclegan_real_g.npz] [--device cpu]

Each HR image takes a route by p ~ U(0, 1) from ``np.random.RandomState(
seed)``, as in the JAX tool: p <= 0.4 the CycleGAN generator A -> B alone;
0.4 < p <= 0.8 the classical degradation alone; p > 0.8 the generator and
then the classical degradation.  Without ``--gan-weights`` every image
takes the classical route.  HR images are resized to twice the LR size by
the port's copy of Pillow's bicubic resample, the generator's outputs to
the LR size by its bilinear one; the classical draws come from a
``torch.Generator(seed)`` on the device (the degradation runs there).

The port writes PNG only.  Each output keeps its HR image's file name,
whatever its extension (``x.jpg`` then holds PNG bytes), so that the LPSR
datasets, which pair LR with HR by identical name and read files by
content, keep every pair.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

HR_EXTS = (".png", ".jpg", ".jpeg")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Synthesize LR training data")
    p.add_argument("--hr-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--gan-weights", type=str, default=None,
                   help="G_AtoB weights (.npz flat state or the reference's "
                        ".pth); classical-only if omitted")
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from lpr_tpu_torch import imageio, native
    from lpr_tpu_torch.data.degradation import (DegradationConfig,
                                                LPDegradation)
    from lpr_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = None
    if args.gan_weights:
        from lpr_tpu_torch.models.cyclegan import load_generator

        gen = load_generator(args.gan_weights, device=dev)

    files = sorted(f for f in os.listdir(args.hr_dir)
                   if f.lower().endswith(HR_EXTS))
    os.makedirs(args.out_dir, exist_ok=True)
    hw = (args.height * 2, args.width * 2)   # degrade from 2x resolution
    deg = LPDegradation(DegradationConfig(lr_hw=(args.height, args.width)),
                        hr_hw=hw)
    rng = np.random.RandomState(args.seed)
    g = torch.Generator(device=dev).manual_seed(args.seed)

    for s in range(0, len(files), args.batch):
        chunk = files[s:s + args.batch]
        hrs = [native.resize_pil_bicubic(
            imageio.read_rgb(os.path.join(args.hr_dir, f)), hw
        ).astype(np.float32) / 255.0 for f in chunk]
        hr = np.stack(hrs)
        routes = rng.rand(len(chunk))

        gan_out = None
        if gen is not None:
            with torch.no_grad():
                x = torch.from_numpy(hr).to(dev)
                gan_out = (gen(x * 2.0 - 1.0) * 0.5 + 0.5).cpu().numpy()
        cls_in = hr if gan_out is None else np.where(
            (routes > 0.8)[:, None, None, None], gan_out, hr)
        with torch.no_grad():
            cls_out = deg(g, torch.from_numpy(cls_in).to(dev)).cpu().numpy()

        for i, f in enumerate(chunk):
            if gan_out is not None and routes[i] <= 0.4:
                out = native.resize_pil_bilinear(
                    (np.clip(gan_out[i], 0, 1) * 255).astype(np.uint8),
                    (args.height, args.width)).astype(np.float32) / 255.0
            else:   # classical or hybrid (hybrid went through the GAN)
                out = cls_out[i]
            imageio.write_png(os.path.join(args.out_dir, f),
                              (np.clip(out, 0, 1) * 255).astype(np.uint8))
        print(f"{min(s + args.batch, len(files))}/{len(files)}", flush=True)


if __name__ == "__main__":
    main()
