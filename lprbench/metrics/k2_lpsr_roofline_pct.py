"""Kernel K2 (LPSR) against its roofline: the least time of its work on
the step's plate slots (``lprbench/work/k2_lpsr.py``) at the card's peaks,
over its mean device time a call in the traced window, found by kernel
name, in % (layer: kernels)."""

from lprbench.work import k2_lpsr as k


def read(ctx):
    return ctx.roofline_pct(k.KERNEL, k.cell_work(ctx.cfg, ctx.mix))
