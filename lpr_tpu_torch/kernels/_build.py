"""Builds the port's CUDA sources into plain-C shared libraries with
``nvcc`` and loads them with ``ctypes``.

Each ``lpr_tpu_torch/csrc/<name>.cu`` becomes
``build/lpr_tpu_torch/liblpr_tpu_torch_<name>_<hash>.so`` at first use, the
hash covering the sources and the flags, so a stale library is never
loaded.  One ``nvcc`` runs per source, all started together.  The sources
have a plain ``extern "C"`` interface and include no PyTorch header, which
keeps a build to seconds; a library is written under a temporary name and
renamed into place, so a build that was cut off leaves no lock behind.
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


class Library:
    """A loaded kernel library and what ``nvcc -Xptxas -v`` said of it."""

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


def sources() -> List[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"liblpr_tpu_torch_{name}_{h.hexdigest()[:16]}.so"


def _ptxas_lines(text: str) -> List[str]:
    return [ln.strip() for ln in text.splitlines()
            if "ptxas info" in ln or "spill" in ln]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Library]:
    """Compile (where not already built) and load the named sources, all
    ``nvcc`` processes started together.  Raises with nvcc's stderr when a
    build fails."""
    names = sources() if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LOADED]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = {}
        for n in todo:
            so = _target(n)
            if so.exists():
                _LOADED[n] = Library(n, so, [])
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
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
                err = f"nvcc timed out after {NVCC_TIMEOUT_S} s\n{err}"
            if proc.returncode != 0:
                failures.append(f"--- {n}.cu ---\n{err}")
                continue
            os.replace(tmp, so)
            _LOADED[n] = Library(n, so, _ptxas_lines(out + err))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return {n: _LOADED[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return build([name])[name].cdll
