"""Work of kernel K2, the LPSR forward, on n crops: a frozen copy of the
port's ``kernels/lpsr.py`` ``lpsr_work``.  (floating-point operations,
bytes): 2 x multiply-adds of every convolution and dense layer at its own
resolution; the input read once (``in_bytes`` a value: 2 for bf16, 4 for
float32), the float32 output written once, the float32 weights read
once."""

from __future__ import annotations

from typing import Tuple

KERNEL = "lpsr_kernel"


def work(n: int, h: int, w: int, in_bytes: int = 2) -> Tuple[int, int]:
    p, p2, p4 = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4)
    ae = (p * 9 * 3 * 12                            # conv_in
          + p * (25 * 12 + 12 * 12)                 # enc0 dw + pw
          + p2 * (25 * 48 + 48 * 12)                # enc1
          + p4 * (25 * 48 + 48 * 48)                # dec0
          + p2 * (25 * 12 + 12 * 48)                # dec1
          + p * 9 * 12 * 3)                         # conv_out
    rdb = p * (9 * 16 * (32 + 48 + 64 + 80) + 96 * 32)
    csar = p * (2 * 9 * 32 * 32 + 32 * 64 + 64 * 32 + 64 * 32) \
        + 32 * 8 + 8 * 32
    rdn = (p * (49 * 3 * 32 + 9 * 32 * 32)          # shallowF1, F2
           + 2 * rdb + 2 * csar
           + p * (128 * 32 + 9 * 32 * 32 + 9 * 32))  # gff0, gff1, final
    n_weights = (9 * 3 * 12 + 2 * (25 * 12 + 12) + 12 * 12 + 12
                 + 25 * 48 + 48 + 48 * 12 + 12 + 25 * 48 + 48 + 48 * 48 + 48
                 + 12 * 48 + 48 + 9 * 12 * 3
                 + 49 * 3 * 32 + 32 + 9 * 32 * 32 + 32
                 + 2 * (9 * 16 * (32 + 48 + 64 + 80) + 4 * 16 + 96 * 32 + 32)
                 + 2 * (9 * 32 * 32 + 32) + 32 * 8 + 8 + 8 * 32 + 32
                 + 32 * 64 + 64 + 2 * (64 * 32 + 32)
                 + 128 * 32 + 32 + 9 * 32 * 32 + 32 + 9 * 32 + 1)
    nbytes = n * p * (3 * in_bytes + 4) + 4 * n_weights
    return 2 * n * (ae + rdn), nbytes


def cell_work(cfg: dict, traffic: dict) -> Tuple[int, int]:
    """K2's work in one served step: every plate slot of the padded batch
    (``max_plates`` a frame) at the SR size, bf16 in."""
    p = cfg["pipeline"]
    h, w = p["sr_hw"]
    return work(traffic["server"]["max_batch"] * p["max_plates"], h, w)
