"""Builds the port's C sources into plain-C shared libraries and loads
them with ``ctypes``: the CUDA kernels (``csrc/<name>.cu``) with ``nvcc``,
the host libraries (``csrc/<name>.cc``: the letterbox and the image
decode) with ``g++``.

Each source becomes ``build/lpr_tpu_torch/liblpr_tpu_torch_<name>_<hash>.so``
at first use, the hash covering the sources, the headers they may include
and the flags, so a stale library is never loaded.  One compiler runs per
source, all started together.  The sources have a plain ``extern "C"``
interface and include no PyTorch header, which keeps a build to seconds; a
library is written under a temporary name and renamed into place, so a
build that was cut off leaves no lock behind.  The host libraries need no
card and no ``nvcc``, so they build and run wherever ``g++`` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lpr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600
# -ffp-contract=off: no fused multiply-add, so the letterbox's float32 taps
# round where the numpy reference rounds (ops/image.py _resize_u8).
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")
# What each host library links, as native/Makefile links the JAX package's.
HOST_LIBS = {"host_letterbox": ("-lpthread",), "host_augment": (),
             "host_decode": ("-ljpeg", "-lpng16", "-lpthread")}


class Library:
    """A loaded library and what its compiler said of it (for a kernel,
    ``nvcc -Xptxas -v``'s registers, shared memory and spills)."""

    def __init__(self, name: str, path: Path, ptxas_log: List[str]):
        self.name = name
        self.path = path
        self.ptxas_log = ptxas_log
        self.cdll = ctypes.CDLL(str(path))


_LOCK = threading.Lock()
_LOADED: Dict[str, Library] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built from source at first use")


def gxx() -> str:
    """Path of ``g++`` on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the host libraries "
                           "(csrc/*.cc) are built from source at first use")
    return found


def sources() -> List[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> List[str]:
    """Names of the host library sources, ``csrc/<name>.cc``."""
    return sorted(p.stem for p in CSRC.glob("*.cc"))


def _target(name: str, suffix: str = ".cu") -> Path:
    flags, headers = ((NVCC_FLAGS, "*.cuh") if suffix == ".cu" else
                      (GXX_FLAGS + HOST_LIBS.get(name, ()), "*.h"))
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(CSRC.glob(headers)) + [CSRC / f"{name}{suffix}"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"liblpr_tpu_torch_{name}_{h.hexdigest()[:16]}.so"


def host_command(name: str, out: Path) -> List[str]:
    """The ``g++`` command that builds ``csrc/<name>.cc`` into ``out``."""
    return [gxx(), *GXX_FLAGS, "-o", str(out), str(CSRC / f"{name}.cc"),
            *HOST_LIBS.get(name, ())]


def _ptxas_lines(text: str) -> List[str]:
    return [ln.strip() for ln in text.splitlines()
            if "ptxas info" in ln or "spill" in ln or "wgmma" in ln]


def _compile(names: List[str], suffix: str, command, log) -> Dict[str, Library]:
    """Compile (where not already built) and load the named sources of one
    suffix, every compiler process started together.  ``command(name,
    out)`` is the compiler's argv; ``log(text)`` what to keep of its output.
    Raises with the compiler's stderr when a build fails."""
    key = {n: n + suffix for n in names}
    with _LOCK:
        todo = [n for n in names if key[n] not in _LOADED]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = {}
        for n in todo:
            so = _target(n, suffix)
            if so.exists():
                _LOADED[key[n]] = Library(n, so, [])
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = command(n, tmp)
            running[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True),
                          tmp, so)
        failures = []
        for n, (proc, tmp, so) in running.items():
            try:
                out, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                err = f"timed out after {NVCC_TIMEOUT_S} s\n{err}"
            if proc.returncode != 0:
                failures.append(f"--- {n}{suffix} ---\n{err}")
                continue
            os.replace(tmp, so)
            _LOADED[key[n]] = Library(n, so, log(out + err))
        if failures:
            tool = "nvcc" if suffix == ".cu" else "g++"
            raise RuntimeError(f"{tool} failed:\n" + "\n".join(failures))
        return {n: _LOADED[key[n]] for n in names}


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Library]:
    """Compile (where not already built) and load the named kernel sources,
    all ``nvcc`` processes started together.  Raises with nvcc's stderr when
    a build fails."""
    names = sources() if names is None else list(names)
    return _compile(names, ".cu", lambda n, out: [
        nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{n}.cu")],
        _ptxas_lines)


def build_host(names: Optional[Iterable[str]] = None) -> Dict[str, Library]:
    """Compile (where not already built) and load the named host library
    sources with ``g++`` (:func:`host_command`), all started together.
    Raises with g++'s stderr when a build fails: a missing ``jpeglib.h`` or
    ``png.h`` is named there."""
    names = host_sources() if names is None else list(names)
    return _compile(names, ".cc", host_command,
                    lambda text: [ln for ln in text.splitlines() if ln])


def missing_headers(name: str) -> List[str]:
    """The system headers that ``csrc/<name>.cc`` includes (``<...>``) and
    ``g++`` cannot find: what keeps the library from building on a machine
    without the image libraries' development files."""
    src = (CSRC / f"{name}.cc").read_text()
    missing = []
    for line in src.splitlines():
        if line.startswith("#include <") and line.rstrip().endswith(".h>"):
            header = line.split("<", 1)[1].split(">", 1)[0]
            probe = subprocess.run(
                [gxx(), "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                capture_output=True, text=True, timeout=60)
            if probe.returncode != 0:
                missing.append(header)
    return missing


def sass_counts(path: Path, opcode: str) -> Dict[str, int]:
    """Instructions of each function in a built library whose opcode
    starts with ``opcode`` (``"HMMA"``: the tensor cores' mma), as
    ``cuobjdump -sass`` from :func:`nvcc`'s toolkit lists them; keys are
    the mangled function names it prints."""
    tool = Path(nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(path)], check=True,
                         capture_output=True, text=True,
                         timeout=NVCC_TIMEOUT_S).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts.setdefault(fn, 0)
        elif fn is not None and "*/" in line:
            # "/*0120*/  @P0 HMMA.16816.F32.BF16 R4, R8, R12, R4 ; /* .. */"
            ins = line.split("*/", 1)[1].split()
            if ins and ins[0].startswith("@"):
                ins = ins[1:]
            if ins and ins[0].startswith(opcode):
                counts[fn] += 1
    return counts


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return build([name])[name].cdll


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cc``, built at first use."""
    return build_host([name])[name].cdll
