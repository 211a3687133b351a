"""Where the K2 (LPSR) kernel's time goes, stage by stage, on the card.

    python -m lpr_tpu_torch.tools.lpsr_stages [--source PATH ...]
        [--n 24 ...] [--dtype bfloat16|float32]

Builds a copy of a K2 source (default ``lpr_tpu_torch/csrc/lpsr.cu``) with
a ``%globaltimer`` stamp after every cluster barrier, as seen by block 0,
into ``build/lpr_tpu_torch/``; runs its instance of ``--dtype`` (bf16, the
serving path's, or float32, the evaluator's) on N random 32x192 crops (at
each N given) with
the repo's LPSR weights in that type; and prints, with the card's name and
power limit, each of the 35 stages' time (the slowest block of the first
cluster sets it, since a stage ends at a barrier), largest first, beside
its multiply-adds (``kernels/lpsr.py`` ``lpsr_stage_work``), its bound
on the tensor cores (bf16: at the 989 TFLOP/s bf16 rate; float32: three
TF32 products a multiply-add at the 495 TFLOP/s TF32 rate) and its route
in the current source: in bf16 ``mma`` (tensor cores) or ``scalar``
(float32 FMA); in float32 ``tf32x3`` (tensor cores, 3xTF32) or
``scalar``.  Each run's output
is held against ``lpsr_plain`` (max and mean abs error).  Several sources
(for example an older one, ``git show <commit>:lpr_tpu_torch/csrc/lpsr.cu
> build/lpsr_old.cu``, or an edited copy) are built at once and run in
turns, each launched with the launcher arguments it declares, so before
and after come from one call on one card.  The stamps cost one timer read
per stage; the kernel is otherwise the same.  Run from the repo root.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from lpr_tpu_torch.kernels.lpsr import (LAUNCH_ARGTYPES, MMA_STAGES, STAGES,
                                        lpsr_stage_work)
from lpr_tpu_torch.tools._timing import PEAK_BF16_FLOPS, PEAK_TF32_FLOPS

_BARRIER = """__device__ __forceinline__ void stage_barrier() {
  __threadfence();
  cg::this_cluster().sync();
}"""
_STAMPED = """__device__ unsigned long long g_stamps[64];
__device__ int g_nstamps;
__device__ __forceinline__ void stamp() {
  if (blockIdx.x == 0 && threadIdx.x == 0 && g_nstamps < 64) {
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

// How many 8-block clusters of the instance (f32: float, else bf16) the
// card runs at once (cudaOccupancyMaxActiveClusters), or -cudaError.
extern "C" int lpr_lpsr_max_clusters(int f32) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 64, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  int n = 0;
  cudaError_t e;
  if (f32) {
    cudaFuncSetAttribute(lpsr_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    e = cudaOccupancyMaxActiveClusters(&n, lpsr_kernel<float>, &cfg);
  } else {
    cudaFuncSetAttribute(lpsr_kernel<bf16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    e = cudaOccupancyMaxActiveClusters(&n, lpsr_kernel<bf16>, &cfg);
  }
  return e == cudaSuccess ? n : -(int)e;
}
"""


def stamped_source(text: str) -> str:
    """The K2 source with a stamp at the kernel's start, after every stage
    barrier and at its end, a C reader of the stamps and one of the
    clusters the card runs at once."""
    for anchor in (_BARRIER, _START, _END):
        if text.count(anchor) != 1:
            raise ValueError(f"K2 source lacks the anchor {anchor[:40]!r}")
    text = text.replace(_BARRIER, _STAMPED)
    text = text.replace(_START, _START + "  stamp();\n")
    text = text.replace(_END, _END[:-1] + "  __syncthreads();\n  stamp();\n}")
    return text + _READ


# A source from before the wide stages' bf16 tiles declares no
# lpr_lpsr_n_mma and launches without the tile arguments.
_OLD_ARGTYPES = ([ctypes.c_void_p] * 2
                 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])


def stage_bounds_us(n, h, w, dtype="bfloat16"):
    """Each stage's least time (us) on an H100 on the tensor cores, where
    every stage could run (the scalar ones too): in bf16 its multiply-adds
    at the bf16 rate; in float32 three times at the TF32 rate (3xTF32, the
    instance's float32-exact route)."""
    work = lpsr_stage_work(n, h, w)
    if dtype == "bfloat16":
        return {k: 2 * v / PEAK_BF16_FLOPS * 1e6 for k, v in work.items()}
    return {k: 3 * 2 * v / PEAK_TF32_FLOPS * 1e6 for k, v in work.items()}


def route(name, dtype="bfloat16"):
    """A stage's route in the current source for the instance of
    ``dtype``."""
    if name not in MMA_STAGES:
        return "scalar"
    return "mma" if dtype == "bfloat16" else "tf32x3"


def report(us, n, h, w, dtype="bfloat16"):
    """Lines, largest time first: stage, time, multiply-adds, bound at its
    route's peak, route."""
    work = lpsr_stage_work(n, h, w)
    bounds = stage_bounds_us(n, h, w, dtype)
    lines = []
    for name, v in sorted(zip(STAGES, us), key=lambda z: -z[1]):
        lines.append(f"{name:14s} {v:9.1f} us  {work[name] / 1e6:9.2f} M "
                     f"multiply-adds  bound {bounds[name]:7.3f} us  "
                     f"{route(name, dtype)}")
    return lines


def build_stamped(text: str, name: str) -> Path:
    """Compile :func:`stamped_source` of a K2 source text into
    ``build/lpr_tpu_torch/liblpr_tpu_torch_<name>_stamped.so``."""
    from lpr_tpu_torch.kernels._build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{name}_stamped.cu"
    src.write_text(stamped_source(text))
    so = BUILD_DIR / f"liblpr_tpu_torch_{src.stem}.so"
    # -I: the includes of the kernel sources (mma_conv.cuh).
    subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=600)
    return so


def stage_us(so: Path, n: int, h: int = 32, w: int = 192, iters: int = 0,
             dtype: str = "bfloat16"
             ) -> Tuple[List[float], Optional[float], Tuple[float, float]]:
    """Each stage's time (us, block 0's clock) of a stamped K2 library's
    ``dtype`` instance on n random h x w crops with the repo's LPSR weights
    in that type, from the last of three runs; with ``iters``, the whole
    kernel's mean ms over that many launches by CUDA events (else None);
    and the last run's (max, mean) abs error against ``lpsr_plain``."""
    from lpr_tpu_torch.kernels import lpsr as kl
    from lpr_tpu_torch.models.lpsr import load_lpsr

    dt = getattr(torch, dtype)
    lib = ctypes.CDLL(str(so))
    fn = lib.lpr_lpsr_bf16 if dt == torch.bfloat16 else lib.lpr_lpsr_f32
    tiles = hasattr(lib, "lpr_lpsr_n_mma")
    fn.argtypes = LAUNCH_ARGTYPES if tiles else _OLD_ARGTYPES
    fn.restype = ctypes.c_int
    lib.lpr_lpsr_scratch_elems.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lpr_lpsr_scratch_elems.restype = ctypes.c_longlong
    lib.lpr_lpsr_read_stamps.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.lpr_lpsr_read_stamps.restype = ctypes.c_int
    packed = kl.lpsr_pack(load_lpsr(
        "checkpoints/lpsr_synth_glare/best_model.npz").to(dt))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((n, h, w, 3), generator=gen, device="cuda").to(dt)
    scratch = torch.empty(n * lib.lpr_lpsr_scratch_elems(h, w), dtype=dt,
                          device="cuda")
    out = torch.empty((n, h, w, 1), dtype=torch.float32, device="cuda")
    offs = (ctypes.c_int * len(packed.offsets))(*packed.offsets)
    # The tiles of the instance's wide stages (an older float32 instance
    # takes them and reads none).
    tile_buf, tile_offs = packed.tiles(dt)
    moffs = (ctypes.c_int * len(tile_offs))(*tile_offs)
    weights = [packed.buf.data_ptr(), offs, len(offs)]
    if tiles:
        weights += [tile_buf.data_ptr(), moffs, len(moffs)]
    stamps = (ctypes.c_ulonglong * 64)()
    lib.lpr_lpsr_read_stamps(stamps)
    for _ in range(3):                       # the last run is reported
        err = fn(x.data_ptr(), *weights, scratch.data_ptr(),
                 out.data_ptr(), n, h, w,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"stamped K2 launch failed: cudaError {err}")
        count = lib.lpr_lpsr_read_stamps(stamps)
    if count != len(STAGES) + 1:
        raise RuntimeError(f"{count} stamps for {len(STAGES)} stages")
    t = [stamps[i] for i in range(count)]
    ms = None
    if iters:
        from lpr_tpu_torch.tools._timing import event_ms

        stream = torch.cuda.current_stream().cuda_stream
        ms = event_ms(lambda: fn(x.data_ptr(), *weights, scratch.data_ptr(),
                                 out.data_ptr(), n, h, w, stream), iters)
        lib.lpr_lpsr_read_stamps(stamps)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        errors = kl.lpsr_errors(out, kl.lpsr_plain(x, packed))
    return [(b - a) / 1e3 for a, b in zip(t, t[1:])], ms, errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", nargs="+",
                    default=["lpr_tpu_torch/csrc/lpsr.cu"])
    ap.add_argument("--n", type=int, nargs="+", default=[24])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)

    from concurrent.futures import ThreadPoolExecutor

    from lpr_tpu_torch.tools._timing import card

    h, w = 32, 192
    with ThreadPoolExecutor(len(args.source)) as pool:
        sos = list(pool.map(
            lambda i: build_stamped(Path(args.source[i]).read_text(),
                                    f"{Path(args.source[i]).stem}_{i}"),
            range(len(args.source))))
    print(f"card: {card(torch.device('cuda'))}")
    clusters = ctypes.CDLL(str(sos[-1])).lpr_lpsr_max_clusters(
        int(args.dtype == "float32"))
    print(f"clusters (images) resident at once: {clusters}")
    bounds = {n: stage_bounds_us(n, h, w, args.dtype) for n in args.n}
    for n in args.n:
        for src, so in zip(args.source, sos):
            us, ms, (max_err, mean_err) = stage_us(so, n, h, w, args.iters,
                                                   args.dtype)
            print(f"K2 stages from {src} at ({n}, {h}, {w}, 3) "
                  f"{args.dtype}: {sum(us):.1f} us in all (block 0's "
                  f"clock); the kernel {ms:.4f} ms (CUDA events, mean of "
                  f"{args.iters} launches of the stamped build); against "
                  f"lpsr_plain max_abs_err {max_err:.3g}, mean "
                  f"{mean_err:.3g}; route as in the current source")
            for line in report(us, n, h, w, args.dtype):
                print(f"  {line}")
            mma_us = sum(v for k, v in zip(STAGES, us) if k in MMA_STAGES)
            mma_bound = sum(v for k, v in bounds[n].items()
                            if k in MMA_STAGES)
            print(f"  the {len(MMA_STAGES)} {route('sf2', args.dtype)} "
                  f"stages {mma_us:.1f} us (bound {mma_bound:.1f}), the "
                  f"{len(STAGES) - len(MMA_STAGES)} scalar stages "
                  f"{sum(us) - mma_us:.1f} us (bound "
                  f"{sum(bounds[n].values()) - mma_bound:.1f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
