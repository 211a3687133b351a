"""Kernel K1 (the detector's fused front) against its roofline: the least
time of its work at the cell's shapes (``lprbench/work/k1_front.py``) at
the card's peaks, over its mean device time a call in the traced window,
found by kernel name, in % (layer: kernels)."""

from lprbench.work import k1_front as k


def read(ctx):
    return ctx.roofline_pct(k.KERNEL, k.cell_work(ctx.cfg, ctx.mix))
