"""Work of kernel K1, the fused front of the plate detector (yolov5s
layers 0-2: the space-to-depth stem, the stride-2 conv and the first C3),
for a batch: a frozen copy of the port's ``kernels/yolo_front.py``
``front_work``.  (floating-point operations, bytes): 2 x multiply-adds of
the six convolutions at their exact output sizes; the input (``in_bytes`` a
value: 2 for bf16, 1 for uint8 frames) and the output read or written
once, plus the packed float32 weights."""

from __future__ import annotations

from typing import Tuple

KERNEL = "front_kernel"


def work(batch: int, h: int, w: int, in_bytes: int = 2) -> Tuple[int, int]:
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    macs = (h2 * w2 * 9 * 12 * 32          # stem
            + h4 * w4 * 9 * 32 * 64        # down
            + h4 * w4 * 64 * 64            # cv1 | cv2
            + h4 * w4 * 32 * 32            # m.cv1
            + h4 * w4 * 9 * 32 * 32        # m.cv2
            + h4 * w4 * 64 * 64)           # cv3
    weights = 4 * (9 * 12 * 32 + 32 + 9 * 32 * 64 + 64 + 64 * 64 + 64
                   + 32 * 32 + 32 + 9 * 32 * 32 + 32 + 64 * 64 + 64)
    nbytes = batch * (h * w * 3 * in_bytes + h4 * w4 * 64 * 2) + weights
    return 2 * macs * batch, nbytes


def cell_work(cfg: dict, traffic: dict) -> Tuple[int, int]:
    """K1's work in one served step: the padded batch at the detector
    input, bf16."""
    h, w = cfg["pipeline"]["det_hw"]
    return work(traffic["server"]["max_batch"], h, w)
