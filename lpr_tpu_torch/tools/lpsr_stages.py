"""Where the K2 (LPSR) kernel's time goes, stage by stage, on the card.

    python -m lpr_tpu_torch.tools.lpsr_stages [--source PATH] [--n 24]

Builds a copy of a K2 source (default ``lpr_tpu_torch/csrc/lpsr.cu``) with
a ``%globaltimer`` stamp after every cluster barrier, as seen by block 0,
into ``build/lpr_tpu_torch/``; runs it on N random 32x192 crops with the
repo's LPSR weights in bf16; and prints, with the card's name and power
limit, each of the 35 stages' time (the slowest block of the first
cluster sets it, since a stage ends at a barrier), largest first.  The
stamps cost one timer read per stage; the kernel is otherwise the same.
Run from the repo root.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

STAGES = (
    ["conv_in", "enc0.dw", "enc0.pw", "enc1.dw", "enc1.pw", "dec0.dw",
     "dec0.pw", "dec1.dw", "dec1.pw", "conv_out", "sf1", "sf2"]
    + [f"rdb0.{k}" for k in ("d0", "d1", "d2", "d3", "lff")]
    + [f"csar0.{k}" for k in ("in0", "in1", "sa1", "sa2", "ca+out")]
    + [f"rdb1.{k}" for k in ("d0", "d1", "d2", "d3", "lff")]
    + [f"csar1.{k}" for k in ("in0", "in1", "sa1", "sa2", "ca+out")]
    + ["gff0", "gff1", "final"])

_BARRIER = """__device__ __forceinline__ void stage_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}"""
_STAMPED = """__device__ unsigned long long g_stamps[64];
__device__ int g_nstamps;
__device__ __forceinline__ void stamp() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[g_nstamps++] = t;
  }
}
__device__ __forceinline__ void stage_barrier() {
  __threadfence();
  cg::this_cluster().sync();
  stamp();
}"""
_START = "  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;\n"
_END = "plain_src<T>(xin, 32, 0), d);\n  }\n}"
_READ = """
extern "C" int lpr_lpsr_read_stamps(unsigned long long* host) {
  int n = 0, zero = 0;
  cudaMemcpyFromSymbol(&n, g_nstamps, sizeof(int));
  cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  cudaMemcpyToSymbol(g_nstamps, &zero, sizeof(int));
  return n;
}
"""


def stamped_source(text: str) -> str:
    """The K2 source with a stamp at the kernel's start, after every stage
    barrier and at its end, and a C reader of the stamps."""
    for anchor in (_BARRIER, _START, _END):
        if text.count(anchor) != 1:
            raise ValueError(f"K2 source lacks the anchor {anchor[:40]!r}")
    text = text.replace(_BARRIER, _STAMPED)
    text = text.replace(_START, _START + "  stamp();\n")
    text = text.replace(_END, _END[:-1] + "  __syncthreads();\n  stamp();\n}")
    return text + _READ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="lpr_tpu_torch/csrc/lpsr.cu")
    ap.add_argument("--n", type=int, default=24)
    args = ap.parse_args()

    from lpr_tpu_torch.kernels import lpsr as kl
    from lpr_tpu_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, nvcc
    from lpr_tpu_torch.models.lpsr import load_lpsr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "lpsr_stamped.cu"
    src.write_text(stamped_source(Path(args.source).read_text()))
    so = BUILD_DIR / "liblpr_tpu_torch_lpsr_stamped.so"
    subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    fn = lib.lpr_lpsr_bf16
    fn.argtypes = ([ctypes.c_void_p] * 2
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.lpr_lpsr_scratch_elems.restype = ctypes.c_longlong

    n, h, w = args.n, 32, 192
    packed = kl.lpsr_pack(load_lpsr(
        "checkpoints/lpsr_synth_glare/best_model.npz").to(torch.bfloat16))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((n, h, w, 3), generator=gen, device="cuda"
                   ).to(torch.bfloat16)
    scratch = torch.empty(n * lib.lpr_lpsr_scratch_elems(h, w),
                          dtype=torch.bfloat16, device="cuda")
    out = torch.empty((n, h, w, 1), dtype=torch.float32, device="cuda")
    offs = (ctypes.c_int * len(packed.offsets))(*packed.offsets)
    stamps = (ctypes.c_ulonglong * 64)()
    lib.lpr_lpsr_read_stamps(stamps)
    for _ in range(3):                       # the last run is reported
        err = fn(x.data_ptr(), packed.buf.data_ptr(), offs, len(offs),
                 scratch.data_ptr(), out.data_ptr(), n, h, w,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"stamped K2 launch failed: cudaError {err}")
        count = lib.lpr_lpsr_read_stamps(stamps)
    if count != len(STAGES) + 1:
        raise RuntimeError(f"{count} stamps for {len(STAGES)} stages")
    t = [stamps[i] for i in range(count)]
    us = [(b - a) / 1e3 for a, b in zip(t, t[1:])]
    print(f"card: {card}")
    print(f"K2 stages from {args.source} at ({n}, {h}, {w}, 3) bf16: "
          f"{(t[-1] - t[0]) / 1e3:.1f} us in all (block 0's clock)")
    for name, v in sorted(zip(STAGES, us), key=lambda z: -z[1]):
        print(f"  {name:14s} {v:9.1f} us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
