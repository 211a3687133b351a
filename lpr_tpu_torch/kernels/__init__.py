"""Hand-written CUDA kernels for Hopper (sources in ``lpr_tpu_torch/csrc``),
their ctypes builder, and the plain PyTorch version beside each kernel."""

import torch


def refuse_export(name: str) -> None:
    """Raise inside a ``torch.export`` trace.  A kernel is a ctypes call
    that the trace cannot hold, and tracing its plain version instead would
    export something else than the kernel the path runs: each wrapper calls
    this before it launches its kernel or runs its plain version."""
    if torch.compiler.is_exporting():
        raise RuntimeError(
            f"{name} is a hand-written CUDA kernel called through ctypes, "
            f"which torch.export cannot trace: export the model's plain "
            f"forward (no front=/mid=/packed=, no int8 convs)")
