"""CycleGAN training CLI (counterpart of ``lpr_tpu/cli/train_cyclegan.py``,
reference ``train/cyclegans.py:199-226``).

    python -m lpr_tpu_torch.cli.train_cyclegan --dataroot data/ \\
        [--epochs 400] [--device cpu]

``--dataroot`` holds ``trainA/`` (HR) and ``trainB/`` (LR).  Every
``--ckpt-every`` epochs both generators are written as flat npz states,
``netG_AtoB_epoch_{n}.npz`` and ``netG_BtoA_epoch_{n}.npz``, which either
package (and ``create_lr --gan-weights``) loads.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the degradation CycleGAN")
    p.add_argument("--dataroot", required=True,
                   help="folder with trainA/ (HR) and trainB/ (LR)")
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--ckpt-dir", default="checkpoints/cyclegan")
    p.add_argument("--ckpt-every", type=int, default=50)  # reference :188
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from lpr_tpu_torch.data.datasets import UnpairedImageDataset
    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.train.cyclegan import CycleGANConfig, CycleGANTrainer
    from lpr_tpu_torch.weights.checkpoint import save_state

    dev = resolve_device(args.device)
    ds = UnpairedImageDataset(args.dataroot, (args.height, args.width))
    trainer = CycleGANTrainer(CycleGANConfig(lr=args.lr), device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(0))
    os.makedirs(args.ckpt_dir, exist_ok=True)

    for epoch in range(args.epochs):
        metrics = None
        for a, b in ds.batches(args.batch_size):
            if a.shape[0] < args.batch_size:
                continue
            state, metrics = trainer.step(state, a, b)
        if metrics:
            print(f"epoch {epoch}: G {metrics['g_loss']:.4f} "
                  f"(id {metrics['id']:.3f} gan {metrics['gan']:.3f} "
                  f"cyc {metrics['cyc']:.3f}) "
                  f"D_A {metrics['d_a_loss']:.4f} "
                  f"D_B {metrics['d_b_loss']:.4f}", flush=True)
        if (epoch + 1) % args.ckpt_every == 0:
            for which, name in (("ab", "AtoB"), ("ba", "BtoA")):
                save_state(f"{args.ckpt_dir}/netG_{name}_epoch_{epoch + 1}"
                           f".npz", state["g"][which])
    print("done")


if __name__ == "__main__":
    main()
