"""K1's design alternatives, timed side by side on the card.

    python -m lpr_tpu_torch.tools.front_variants [--only NAME ...]
        [--batch 8] [--iters 30] [--rounds 3] [--list]

Each variant (:data:`VARIANTS`) is a text edit of the committed
``lpr_tpu_torch/csrc/yolo_front.cu``: it undoes one of the kernel's design
choices or tries another warp tile, tile size or weight route.  All are
built with ``nvcc`` at once into ``build/lpr_tpu_torch/variants/`` (the
committed source as ``base``), loaded with ``ctypes`` in place of K1's own
library, held against ``front_plain`` on two frames (errors printed;
``no_vertical_halo`` computes wrong outputs on purpose and is read for its
time only), and timed at (batch, 736, 1280, 3) bf16 with CUDA events, the
mean of ``--iters`` launches, the variants taken in turns (forward, then
backward) over ``--rounds`` rounds, beside the card's name and power limit.
Per variant it prints nvcc's registers and spills for ``front_kernel<FULL>``,
the best and every round's ms, and the stage variants' ms.  ``--list``
prints the variants and checks that every edit applies, on any machine.
Run from the repo root.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "yolo_front.cu"
DET_HW = (736, 1280)

# The committed SiLU's arithmetic, which the SiLU variants replace.
_SILU = (
    """  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  const float y = v * r;""")


def _silu(body: str) -> List[Tuple[str, str]]:
    return [(_SILU, f"  const float y = {body};")]


_BRANCHY = [
    ("""  const uint32_t v = pack2(silu_flush(a), silu_flush(b));
  return in_domain ? v : 0u;""",
     """  return in_domain ? pack2(silu_flush(a), silu_flush(b)) : 0u;"""),
    ("""        const int p =
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
_TILES = {"conv_mma<SH * SW, 32, 9, ": "2, 4>(",
          "conv_mma<DP, 64, 18, ": "3, 4>(",
          "conv_mma<OP, 32, 18, ": "1, 4>(",
          "conv_mma<OP, 64, 4, ": "1, 8>("}


def _tile(call: str, mt: int, ntw: int) -> Tuple[str, str]:
    return call + _TILES[call], f"{call}{mt}, {ntw}>("


# The weights as B fragments staged once a block into shared memory (83 KB
# more, so one block an SM) instead of read with __ldg from L1/L2.
_WEIGHTS_IN_SMEM = [
    ("__launch_bounds__(NTHREADS, 2)", "__launch_bounds__(NTHREADS, 1)"),
    ("constexpr int SMEM_BYTES = REGION_A + REGION_B;",
     "constexpr int SMEM_BYTES = REGION_A + REGION_B + 5184 * 16;"),
    ("__ldg(wf + (s * (NT / 2)", "*(wf + (s * (NT / 2)"),
    ("    for (int e = threadIdx.x; e < FR_ROWS * FR_CHUNKS; e += NTHREADS) {",
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
    ("conv_mma<SH * SW, 32, 9, 2, 4>(", "conv_mma<16 * SW, 32, 9, 2, 4>("),
    ("conv_mma<DP, 64, 18, 3, 4>(", "conv_mma<8 * DW, 64, 18, 3, 4>("),
    ("conv_mma<DP, 64, 4, 3, 4>(", "conv_mma<8 * DW, 64, 4, 3, 4>("),
    ("conv_mma<DP, 32, 2, 3, 2>(", "conv_mma<8 * DW, 32, 2, 3, 2>("),
]

# name -> (what it changes, edits of the committed source)
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
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
                 [_tile("conv_mma<SH * SW, 32, 9, ", 1, 4)]),
    "stem_mt4": ("stem warp tile 4 x 4", [_tile("conv_mma<SH * SW, 32, 9, ",
                                                4, 4)]),
    "down_mt2": ("down warp tile 2 x 4 (was 3 x 4)",
                 [_tile("conv_mma<DP, 64, 18, ", 2, 4)]),
    "c3_split": ("m.cv2 2 x 2 (was 1 x 4), cv3 2 x 4 (was 1 x 8)",
                 [_tile("conv_mma<OP, 32, 18, ", 2, 2),
                  _tile("conv_mma<OP, 64, 4, ", 2, 4)]),
    "weights_in_smem": ("B fragments staged in shared memory, one block "
                        "an SM", _WEIGHTS_IN_SMEM),
    "no_vertical_halo": ("work of a column-band walk (wrong outputs; time "
                         "only)", _NO_VERTICAL_HALO),
}


def apply(source: str, edits: Sequence[Tuple[str, str]]) -> str:
    """``source`` with each (old, new) replaced; raises ValueError unless
    ``old`` occurs exactly once."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"edit anchor found {source.count(old)} times "
                             f"in {SOURCE.name}: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build(names: Sequence[str]) -> Dict[str, Tuple[tuple, List[str]]]:
    """Each named variant built with nvcc (all started together) and
    loaded: name -> (its launchers, as ``yolo_front.bind`` gives them;
    nvcc's lines on front_kernel<FULL>)."""
    from lpr_tpu_torch.kernels import _build
    from lpr_tpu_torch.kernels import yolo_front as kf

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = out_dir / f"front_{name}.cu"
        cu.write_text(apply(source, VARIANTS[name][1]))
        so = out_dir / f"libfront_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        full = [i for i, ln in enumerate(lines)
                if "Compiling entry" in ln and "front_kernelILi3E" in ln]
        report = [ln.strip() for ln in lines[full[0] + 1:full[0] + 4]
                  if "spill" in ln or "Used" in ln] if full else []
        libs[name] = (kf.bind(ctypes.CDLL(str(so))), report)
    return libs


@contextlib.contextmanager
def launching(launchers):
    """K1's wrappers launch a variant's ``launchers`` (from
    :func:`build`) inside the block."""
    from lpr_tpu_torch.kernels import yolo_front as kf

    saved = kf._launchers
    kf._launchers = lambda: launchers
    try:
        yield
    finally:
        kf._launchers = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS),
                    help="these variants (base is always timed)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--list", action="store_true",
                    help="print the variants, check their edits, stop")
    args = ap.parse_args(argv)
    names = ["base"] + [n for n in (args.only or VARIANTS) if n != "base"]
    source = SOURCE.read_text()
    if args.list:
        for n in names:
            apply(source, VARIANTS[n][1])
            print(f"{n:18s} {VARIANTS[n][0]}")
        return 0

    import torch

    from lpr_tpu_torch.device import resolve_device
    from lpr_tpu_torch.kernels import yolo_front as kf
    from lpr_tpu_torch.models.yolo import load_plate_detector
    from lpr_tpu_torch.tools import _timing

    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    libs = build(names)
    plate = load_plate_detector("checkpoints/plate_det640.npz", dev)
    packed = kf.front_pack(plate.to(torch.bfloat16))
    gen = torch.Generator(device=dev).manual_seed(0)
    x2 = torch.rand((2, *DET_HW, 3), generator=gen, device=dev
                    ).to(torch.bfloat16)
    x = torch.rand((args.batch, *DET_HW, 3), generator=gen, device=dev
                   ).to(torch.bfloat16)
    ref = kf.front_plain(x2, packed)
    print(f"card: {_timing.card(dev)}")
    print(f"K1 variants at {tuple(x.shape)} bf16, CUDA events, mean of "
          f"{args.iters} launches, best of {args.rounds} rounds in turns; "
          f"errors against front_plain at {tuple(x2.shape)}")
    times: Dict[str, List[float]] = {n: [] for n in names}
    for r in range(args.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            with launching(libs[n][0]):
                times[n].append(_timing.event_ms(
                    lambda: kf.yolo_front(x, packed), args.iters, dev))
    for n in names:
        with launching(libs[n][0]):
            got = kf.yolo_front(x2, packed)
            torch.cuda.synchronize(dev)
            max_err, ratio, interior = kf.front_errors(got, ref)
            differ = int((got != ref).sum().item())
            stages = {s: round(_timing.event_ms(
                lambda: kf.front_stage(x, packed, s), args.iters, dev), 4)
                for s in kf.STAGES}
        print(f"{n}: {VARIANTS[n][0]}")
        print(f"    K1 {min(times[n]):.4f} ms (rounds "
              f"{[round(t, 4) for t in times[n]]}); stages {stages}")
        print(f"    max_abs_err {max_err}, ratio {ratio:.4f}, interior mean "
              f"{interior:.3e}, {differ} of {got.numel()} differ; "
              f"nvcc {'; '.join(libs[n][1])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
