"""K1's and K3's design alternatives, timed side by side on the card.

    python -m lpr_tpu_torch.tools.front_variants [--kernel front|mid]
        [--only NAME ...] [--parent DIR] [--batch 8] [--iters 30]
        [--rounds 3] [--list]

Each variant (:data:`VARIANTS` for K1, the default ``--kernel front``;
:data:`MID_VARIANTS` for K3, ``--kernel mid``) is a set of text edits of
the committed sources, each edit naming the file it applies to: the
kernel's ``lpr_tpu_torch/csrc/yolo_front.cu`` or ``csrc/yolo_mid.cu``, or
the implicit-GEMM routine both include, ``csrc/implicit_gemm.cuh``
(:data:`KERNELS`).  A variant undoes one of the kernel's design choices or
tries another warp tile, tile size or weight route.  Each variant's edited
copies of both files go to ``build/lpr_tpu_torch/variants/<kernel>_<name>/``,
and all are built with ``nvcc`` at once (the committed sources as
``base``; ``--parent DIR`` adds ``parent``, the kernel's source in DIR with
the headers beside it, such as an older commit's ``csrc`` from ``git
archive``), loaded with ``ctypes`` in place of the kernel's own library,
held against its plain version (K1 on two frames, K3 on K1's output for
them; errors printed, and whether the output is bit for bit ``base``'s;
a variant marked "time only" computes wrong outputs on purpose), and timed
at the production shape in bf16 (K1 on (batch, 736, 1280, 3), K3 on K1's
output for it) with CUDA events, the mean of ``--iters`` launches, the
variants taken in turns (forward, then backward) over ``--rounds`` rounds,
beside the card's name and power limit.  Per variant it prints nvcc's
registers and spills for the kernel (``front_kernel<FULL>``,
``mid_kernel``), the best and every round's ms, and for K1 the stage
variants' ms.  ``--list`` prints the variants and checks that every edit
applies, on any machine.  Run from the repo root.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "yolo_front.cu"
MID_SOURCE = CSRC / "yolo_mid.cu"
GEMM = "implicit_gemm.cuh"     # the routine K1 and K3 include
DET_HW = (736, 1280)

# The committed SiLU's arithmetic, which the SiLU variants replace.
_SILU = (
    """  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  const float y = v * r;""")


# (file: the kernel's source or GEMM, old text, new text)
Edit = Tuple[str, str, str]


def _silu(body: str) -> List[Edit]:
    return [(GEMM, _SILU, f"  const float y = {body};")]


_BRANCHY = [
    (GEMM, """  const uint32_t v = pack2(silu_flush(a), silu_flush(b));
  return in_domain ? v : 0u;""",
     """  return in_domain ? pack2(silu_flush(a), silu_flush(b)) : 0u;"""),
    (GEMM, """        const int p =
            min((mg * MT + i) * 16 + (lane >> 2) + 8 * h, NPOS - 1);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          epi(p, (ng * NTW + j) * 8 + 2 * (lane & 3), acc[i][j][2 * h],
              acc[i][j][2 * h + 1]);""",
     """        const int p = (mg * MT + i) * 16 + (lane >> 2) + 8 * h;
        if (p < NPOS) {
#pragma unroll
          for (int j = 0; j < NTW; ++j)
            epi(p, (ng * NTW + j) * 8 + 2 * (lane & 3), acc[i][j][2 * h],
                acc[i][j][2 * h + 1]);
        }"""),
]


# The warp tile (MT m-tiles x NTW n-tiles) of the conv_mma calls that
# start with each key, as committed.
_TILES = {"conv_mma<NWARPS, SH * SW, 32, 9, ": "2, 4>(",
          "conv_mma<NWARPS, DP, 64, 18, ": "3, 4>(",
          "conv_mma<NWARPS, OP, 32, 18, ": "1, 4>(",
          "conv_mma<NWARPS, OP, 64, 4, ": "1, 8>("}


def _tile(call: str, mt: int, ntw: int) -> Edit:
    return SOURCE.name, call + _TILES[call], f"{call}{mt}, {ntw}>("


# The weights as B fragments staged once a block into shared memory (83 KB
# more, so one block an SM) instead of read with __ldg from L1/L2.
_WEIGHTS_IN_SMEM = [
    (SOURCE.name, "__launch_bounds__(NTHREADS, 2)",
     "__launch_bounds__(NTHREADS, 1)"),
    (SOURCE.name, "constexpr int SMEM_BYTES = REGION_A + REGION_B;",
     "constexpr int SMEM_BYTES = REGION_A + REGION_B + 5184 * 16;"),
    (GEMM, "__ldg(wf + (s * (NT / 2)", "*(wf + (s * (NT / 2)"),
    (SOURCE.name,
     "    for (int e = threadIdx.x; e < FR_ROWS * FR_CHUNKS; e += NTHREADS) {",
     """    {
      const uint4* ws =
          reinterpret_cast<const uint4*>(smem + REGION_A + REGION_B);
      for (int e = threadIdx.x; e < F_END; e += NTHREADS)
        cp_async16(smem_u32(ws + e), wf + e, true);
      wf = ws;
    }
    for (int e = threadIdx.x; e < FR_ROWS * FR_CHUNKS; e += NTHREADS) {"""),
]

# The work of a block that walks down a column band and keeps the last
# rows of each layer: 16 new stem rows and 8 new down rows a tile, no
# vertical halo.  Its outputs are wrong; its time bounds what such a
# walk could save.
_NO_VERTICAL_HALO = [
    (SOURCE.name, f"conv_mma<NWARPS, {old}", f"conv_mma<NWARPS, {new}")
    for old, new in (("SH * SW, 32, 9, 2, 4>(", "16 * SW, 32, 9, 2, 4>("),
                     ("DP, 64, 18, 3, 4>(", "8 * DW, 64, 18, 3, 4>("),
                     ("DP, 64, 4, 3, 4>(", "8 * DW, 64, 4, 3, 4>("),
                     ("DP, 32, 2, 3, 2>(", "8 * DW, 32, 2, 3, 2>("))]

# name -> (what it changes, edits of the committed sources)
VARIANTS: Dict[str, Tuple[str, List[Edit]]] = {
    "base": ("the committed kernel", []),
    "first_version": (
        "IEEE SiLU and the branching epilogue (this kernel's first build)",
        _silu("v / (1.0f + expf(-v))") + _BRANCHY),
    "ieee_silu": ("SiLU as v / (1 + expf(-v)), IEEE division",
                  _silu("v / (1.0f + expf(-v))")),
    "rcp_rn_silu": ("SiLU with __expf and the IEEE reciprocal __frcp_rn",
                    _silu("v * __frcp_rn(1.0f + __expf(-v))")),
    "fdividef_silu": ("SiLU with __expf and __fdividef (not ftz)",
                      _silu("__fdividef(v, 1.0f + __expf(-v))")),
    "branchy_epilogue": ("epilogue skips padding rows and branches on the "
                         "domain", _BRANCHY),
    "stem_mt1": ("stem warp tile 1 x 4 (was 2 x 4)",
                 [_tile("conv_mma<NWARPS, SH * SW, 32, 9, ", 1, 4)]),
    "stem_mt4": ("stem warp tile 4 x 4",
                 [_tile("conv_mma<NWARPS, SH * SW, 32, 9, ", 4, 4)]),
    "down_mt2": ("down warp tile 2 x 4 (was 3 x 4)",
                 [_tile("conv_mma<NWARPS, DP, 64, 18, ", 2, 4)]),
    "c3_split": ("m.cv2 2 x 2 (was 1 x 4), cv3 2 x 4 (was 1 x 8)",
                 [_tile("conv_mma<NWARPS, OP, 32, 18, ", 2, 2),
                  _tile("conv_mma<NWARPS, OP, 64, 4, ", 2, 4)]),
    "weights_in_smem": ("B fragments staged in shared memory, one block "
                        "an SM", _WEIGHTS_IN_SMEM),
    "no_vertical_halo": ("work of a column-band walk (wrong outputs; time "
                         "only)", _NO_VERTICAL_HALO),
}


def _mid_tile(call: str, old: str, new: str) -> Edit:
    """K3's conv_mma call with NPOS, N, KS ``call`` and warp tile ``old``
    (MT, NTW), given warp tile ``new``."""
    return (MID_SOURCE.name, f"conv_mma<NWARPS, {call}, {old}, B_RING>(",
            f"conv_mma<NWARPS, {call}, {new}, B_RING>(")


# K3's variants: name -> (what it changes, edits of the committed sources)
MID_VARIANTS: Dict[str, Tuple[str, List[Edit]]] = {
    "base": ("the committed kernel", []),
    "b_ring4": ("B fragments through a ring of 4 k-step slices in shared "
                "memory, loaded with cp.async, warps in lockstep",
                [(MID_SOURCE.name, "constexpr int B_RING = 0;",
                  "constexpr int B_RING = 4;")]),
    "b_ring6": ("the same with a ring of 6 slices",
                [(MID_SOURCE.name, "constexpr int B_RING = 0;",
                  "constexpr int B_RING = 6;")]),
    "b_kstep0": ("every k-step reads k-step 0's B fragments, which stay in "
                 "L1 (time only)",
                 [(GEMM, "__ldg(wf + (s * (NT / 2) + ng",
                   "__ldg(wf + (ng")]),
    "silu_linear": ("the epilogue without SiLU, y = v (time only)",
                    _silu("v")),
    "stage_only": ("stages the input window and stops (time only)",
                   [(MID_SOURCE.name, """    cp_async_wait<0>();
  }
  __syncthreads();
""", """    cp_async_wait<0>();
  }
  __syncthreads();
  return;
""")]),
    "l3_4x4": ("L3 warp tile 4 x 4 (was 2 x 8)",
               [_mid_tile("LP, 128, 36", "2, 8", "4, 4")]),
    "l3_8x2": ("L3 warp tile 8 x 2 (was 2 x 8)",
               [_mid_tile("LP, 128, 36", "2, 8", "8, 2")]),
    "c12_2x8": ("cv1|cv2 warp tile 2 x 8 (was 4 x 4)",
                [_mid_tile("LP, 128, 8", "4, 4", "2, 8")]),
    "cv3_1x8": ("cv3 warp tile 1 x 8 (was 2 x 4)",
                [_mid_tile("OP, 128, 8", "2, 4", "1, 8")]),
}

# kernel -> (its source, its variants)
KERNELS = {"front": (SOURCE, VARIANTS), "mid": (MID_SOURCE, MID_VARIANTS)}


def sources(kernel: str = "front") -> Dict[str, str]:
    """The committed text of the kernel's source and of the implicit-GEMM
    routine, by file name: the files its variants may edit."""
    return {f: (CSRC / f).read_text()
            for f in (KERNELS[kernel][0].name, GEMM)}


def apply(texts: Dict[str, str], edits: Sequence[Edit]) -> Dict[str, str]:
    """``texts`` (file name -> text) with each (file, old, new) edit made;
    raises ValueError unless ``old`` occurs exactly once in ``file``."""
    texts = dict(texts)
    for name, old, new in edits:
        if name not in texts:
            raise ValueError(f"edit of an unknown file {name!r}")
        n = texts[name].count(old)
        if n != 1:
            raise ValueError(f"edit anchor found {n} times in {name}: "
                             f"{old[:60]!r}")
        texts[name] = texts[name].replace(old, new)
    return texts


def build(kernel: str, names: Sequence[str], parent: Path = None
          ) -> Dict[str, Tuple[object, List[str]]]:
    """Each named variant of ``kernel`` built with nvcc (all started
    together) and loaded, and ``parent`` (a directory holding another copy
    of the kernel's source and its headers) as variant "parent": name ->
    (its launchers, as the kernel module's ``bind`` gives them; nvcc's
    lines on the kernel's production instance)."""
    from lpr_tpu_torch.kernels import _build
    from lpr_tpu_torch.kernels import yolo_front as kf
    from lpr_tpu_torch.kernels import yolo_mid as km

    source, variants = KERNELS[kernel]
    # K1's bf16 instance front_kernel<FULL, bf16> (front_kernel<FULL> in a
    # source older than the uint8 instance), K3's mid_kernel
    bind, entries = ((kf.bind, ("front_kernelILi3E13__nv_bfloat16",
                                "front_kernelILi3EEv"))
                     if kernel == "front" else (km.bind, ("mid_kernel",)))
    out_dir = _build.BUILD_DIR / "variants"
    texts = sources(kernel)
    jobs = {}
    for name in names:
        d = out_dir / f"{kernel}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for f, text in apply(texts, variants[name][1]).items():
            (d / f).write_text(text)
        jobs[name] = d / source.name
    if parent is not None:
        jobs["parent"] = Path(parent) / source.name
    procs = {}
    for name, cu in jobs.items():
        # a quoted include is looked up beside the source first
        so = out_dir / f"lib{kernel}_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        at = [i for i, ln in enumerate(lines)
              if "Compiling entry" in ln and any(e in ln for e in entries)]
        report = [ln.strip() for ln in lines[at[0] + 1:at[0] + 4]
                  if "spill" in ln or "Used" in ln] if at else []
        libs[name] = (bind(ctypes.CDLL(str(so))), report)
    return libs


@contextlib.contextmanager
def launching(launchers, kernel: str = "front"):
    """The kernel's wrappers launch a variant's ``launchers`` (from
    :func:`build`) inside the block."""
    from lpr_tpu_torch.kernels import yolo_front as kf
    from lpr_tpu_torch.kernels import yolo_mid as km

    mod, attr = (kf, "_launchers") if kernel == "front" else (km, "_launcher")
    saved = getattr(mod, attr)
    setattr(mod, attr, lambda: launchers)
    try:
        yield
    finally:
        setattr(mod, attr, saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="front",
                    help="K1 (front, the default) or K3 (mid)")
    ap.add_argument("--only", nargs="+",
                    help="these variants (base is always timed)")
    ap.add_argument("--parent", type=Path,
                    help="also build and time the kernel's source in this "
                         "directory (with its headers) as 'parent'")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--list", action="store_true",
                    help="print the variants, check their edits, stop")
    args = ap.parse_args(argv)
    kernel = args.kernel
    variants = KERNELS[kernel][1]
    unknown = set(args.only or ()) - set(variants)
    if unknown:
        ap.error(f"no {kernel} variant {sorted(unknown)}")
    names = ["base"] + [n for n in (args.only or variants) if n != "base"]
    texts = sources(kernel)
    if args.list:
        for n in names:
            apply(texts, variants[n][1])
            print(f"{n:18s} {variants[n][0]}")
        return 0

    import torch

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.kernels import yolo_front as kf
    from lpr_tpu_torch.kernels import yolo_mid as km
    from lpr_tpu_torch.models.yolo import load_plate_detector
    from lpr_tpu_torch.tools import _timing

    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    libs = build(kernel, names, args.parent)
    names = list(libs)
    what = dict({n: variants[n][0] for n in variants},
                parent=f"{KERNELS[kernel][0].name} of {args.parent}")
    plate = load_plate_detector("checkpoints/plate_det640.npz", dev
                                ).to(torch.bfloat16)
    packed = kf.front_pack(plate)
    gen = torch.Generator(device=dev).manual_seed(0)
    x2 = torch.rand((2, *DET_HW, 3), generator=gen, device=dev
                    ).to(torch.bfloat16)
    x = torch.rand((args.batch, *DET_HW, 3), generator=gen, device=dev
                   ).to(torch.bfloat16)
    if kernel == "front":
        run, plain, errors = kf.yolo_front, kf.front_plain, kf.front_errors
        small, big = x2, x
    else:        # K3 on the committed K1's output
        mpacked = km.mid_pack(plate)
        small, big = kf.yolo_front(x2, packed), kf.yolo_front(x, packed)
        packed = mpacked
        run, plain, errors = km.yolo_mid, km.mid_plain, km.mid_errors
    ref = plain(small, packed)
    print(f"card: {_timing.card(dev)}")
    print(f"{kernel} variants at {tuple(big.shape)} bf16, CUDA events, mean "
          f"of {args.iters} launches, best of {args.rounds} rounds in turns; "
          f"errors against the plain version at {tuple(small.shape)}")
    times: Dict[str, List[float]] = {n: [] for n in names}
    for r in range(args.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            with launching(libs[n][0], kernel):
                times[n].append(_timing.event_ms(
                    lambda: run(big, packed), args.iters, dev))
    base_out = None
    for n in names:
        with launching(libs[n][0], kernel):
            got = run(small, packed)
            if base_out is None:
                base_out = got
            torch.cuda.synchronize(dev)
            max_err, ratio, interior = errors(got, ref)
            differ = int((got != ref).sum().item())
            stages = {s: round(_timing.event_ms(
                lambda: kf.front_stage(big, packed, s), args.iters, dev), 4)
                for s in kf.STAGES} if kernel == "front" else None
        print(f"{n}: {what[n]}")
        print(f"    {kernel} {min(times[n]):.4f} ms (rounds "
              f"{[round(t, 4) for t in times[n]]})"
              + (f"; stages {stages}" if stages else ""))
        print(f"    max_abs_err {max_err}, ratio {ratio:.4f}, interior mean "
              f"{interior:.3e}, {differ} of {got.numel()} differ; bit "
              f"for bit base's: {bool(torch.equal(got, base_out))}; "
              f"nvcc {'; '.join(libs[n][1])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
