"""ctypes bindings of the port's host libraries (counterpart of
``lpr_tpu/native/__init__.py``).

Three plain-C libraries, built with ``g++`` at first use by
:mod:`lpr_tpu_torch.kernels._build` into ``build/lpr_tpu_torch/``:

- ``csrc/host_letterbox.cc`` (no dependency): the threaded NHWC batch
  letterbox of the packed detector input (:func:`letterbox_batch_into`)
  and Pillow's bilinear and bicubic resamples (:func:`resize_pil_bilinear`,
  :func:`resize_pil_bicubic`);
- ``csrc/host_augment.cc`` (no dependency): the detector data
  pipeline's OpenCV operations, :func:`cv_resize_linear`,
  :func:`cv_warp_affine` and :func:`cv_hsv_lut`;
- ``csrc/host_decode.cc`` (libjpeg, libpng): :func:`decode_image` and
  :func:`load_letterbox_batch`, the decode path of the JAX package's
  ``native/lpr_native.cc``.

There is no Python fallback: a library that does not build raises with
the compiler's message (a missing ``jpeglib.h`` or ``png.h`` is named
there).  ``ctypes`` releases the interpreter lock for the length of each
call, so the server's decode threads run in parallel.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIBS = {}
# Threads of a letterbox call when the caller names none: one a core the
# process may run on, at most this many (the work is a memory copy).
MAX_THREADS = 8


def _threads(n_threads: int) -> int:
    if n_threads > 0:
        return int(n_threads)
    return max(1, min(MAX_THREADS, len(os.sched_getaffinity(0))))


def library(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cc`` (``host_letterbox``,
    ``host_augment`` or ``host_decode``), built at first use; raises with g++'s message when it
    does not build."""
    from lpr_tpu_torch.kernels import _build

    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        lib = _build.host_library(name)
        if name == "host_letterbox":
            lib.lpr_letterbox_batch.restype = None
            lib.lpr_letterbox_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
                ctypes.c_int]
            for fn in (lib.lpr_resize_pil_bilinear,
                       lib.lpr_resize_pil_bicubic):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        elif name == "host_augment":
            lib.lpr_cv_resize_linear.restype = ctypes.c_int
            lib.lpr_cv_resize_linear.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.lpr_cv_warp_affine.restype = ctypes.c_int
            lib.lpr_cv_warp_affine.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.lpr_cv_hsv_lut.restype = None
            lib.lpr_cv_hsv_lut.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
        else:
            lib.lpr_load_letterbox_batch.restype = ctypes.c_int
            lib.lpr_load_letterbox_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
                ctypes.c_int]
            lib.lpr_decode_image.restype = ctypes.c_void_p
            lib.lpr_decode_image.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.lpr_free.restype = None
            lib.lpr_free.argtypes = [ctypes.c_void_p]
        _LIBS[name] = lib
        return lib


def _address(a, shape: Tuple[int, ...], what: str) -> int:
    """The data address of a C-contiguous uint8 array or CPU tensor of
    ``shape`` (a writable one for an output)."""
    if isinstance(a, np.ndarray):
        ok = (a.dtype == np.uint8 and a.flags.c_contiguous
              and a.flags.writeable)
        addr = a.ctypes.data
    else:   # a torch tensor on the host (the pinned staging buffer)
        import torch

        ok = (a.dtype == torch.uint8 and a.device.type == "cpu"
              and a.is_contiguous())
        addr = a.data_ptr()
    if not ok or tuple(a.shape) != tuple(shape):
        raise ValueError(f"{what}: expected a C-contiguous writable uint8 "
                         f"host array of shape {tuple(shape)}, got "
                         f"{getattr(a, 'dtype', type(a))} {tuple(a.shape)}")
    return addr


def _frame_addresses(frames):
    """(ctypes array of the frames' addresses, B, (h, w), the arrays it
    points into) for a uint8 batch (B, H, W, 3) or a sequence of B
    (H, W, 3) frames of one shape."""
    if isinstance(frames, np.ndarray):
        keep = [np.ascontiguousarray(frames)]
        if keep[0].ndim != 4:
            raise ValueError(f"expected uint8 frames (B, H, W, 3), got "
                             f"{frames.dtype} {frames.shape}")
        frame_list = list(keep[0])          # views into the one batch
    else:
        keep = frame_list = [np.ascontiguousarray(f) for f in frames]
    shapes = {f.shape for f in frame_list}
    dtypes = {f.dtype for f in frame_list}
    if len(shapes) > 1 or dtypes - {np.dtype(np.uint8)} or any(
            len(sh) != 3 or sh[2] != 3 for sh in shapes):
        raise ValueError(f"expected uint8 frames (B, H, W, 3) of one shape, "
                         f"got {sorted(map(str, dtypes))} {sorted(shapes)}")
    h, w = next(iter(shapes))[:2] if shapes else (0, 0)
    addrs = (ctypes.c_void_p * max(len(frame_list), 1))(
        *[f.ctypes.data for f in frame_list])
    return addrs, len(frame_list), (h, w), keep


def letterbox_batch_into(frames, out, geom: Sequence[int], fill: int = 0,
                         n_threads: int = 0) -> None:
    """Letterbox uint8 frames, a batch (B, H, W, 3) or a sequence of B
    (H, W, 3) frames of one shape, into ``out`` (B, oh, ow, 3), a uint8
    numpy array or CPU tensor (the pinned staging buffer): each frame
    resized to (nh, nw) with the native ``letterbox_into``'s bilinear taps
    and placed at (top, left), ``geom = (nh, nw, top, left)``, the rest
    ``fill``.  The caller computes the geometry (``ops/image.py``
    ``letterbox_geom``); (H, W, 0, 0) into (B, H, W, 3) gathers the frames
    into one batch.  Threads split the output rows (``n_threads`` 0: one a
    core, at most :data:`MAX_THREADS`)."""
    # _keep holds the arrays that addrs points into until the call returns
    addrs, B, (h, w), _keep = _frame_addresses(frames)
    if len(out.shape) != 4:
        raise ValueError(f"out: expected (B, oh, ow, 3), got {out.shape}")
    oh, ow = int(out.shape[1]), int(out.shape[2])
    nh, nw, top, left = (int(v) for v in geom)
    if not (1 <= nh and 1 <= nw and 0 <= top and 0 <= left
            and top + nh <= oh and left + nw <= ow):
        raise ValueError(f"letterbox geometry {tuple(geom)} does not fit "
                         f"({oh}, {ow})")
    dst = _address(out, (B, oh, ow, 3), "out")
    if B == 0:
        return
    library("host_letterbox").lpr_letterbox_batch(
        addrs, B, h, w, dst, oh, ow, nh, nw, top, left, int(fill),
        _threads(n_threads))


def gather_into(frames, out) -> None:
    """Copy frames, a batch (B, H, W, 3) or a sequence of B (H, W, 3), into
    ``out`` (B, H, W, 3) uint8 with the letterbox's threads (a pad-only
    letterbox): how a host batch reaches the pinned staging buffer."""
    h, w = int(out.shape[1]), int(out.shape[2])
    letterbox_batch_into(frames, out, (h, w, 0, 0))


def _resize_pil(fn: str, img: np.ndarray, out_hw: Tuple[int, int]
                ) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 (H, W, 3) image, got "
                         f"{img.dtype} {img.shape}")
    oh, ow = (int(v) for v in out_hw)
    out = np.empty((oh, ow, 3), np.uint8)
    rc = getattr(library("host_letterbox"), fn)(
        img.ctypes.data, img.shape[0], img.shape[1], out.ctypes.data, oh, ow)
    if rc != 0:
        raise ValueError(f"cannot resize {img.shape} to {(oh, ow)}")
    return out


def resize_pil_bilinear(img: np.ndarray, out_hw: Tuple[int, int]
                        ) -> np.ndarray:
    """(H, W, 3) uint8 -> (oh, ow, 3) uint8, equal byte for byte to
    Pillow's ``Image.fromarray(img).resize((ow, oh), Image.BILINEAR)``
    (how the JAX server resizes an encoded image of another shape)."""
    return _resize_pil("lpr_resize_pil_bilinear", img, out_hw)


def resize_pil_bicubic(img: np.ndarray, out_hw: Tuple[int, int]
                       ) -> np.ndarray:
    """(H, W, 3) uint8 -> (oh, ow, 3) uint8, equal byte for byte to
    Pillow's ``Image.fromarray(img).resize((ow, oh), Image.BICUBIC)``,
    ``resize``'s default (the evaluator's SR input, ``cli/sr``'s input and
    the pasted crops of the panels)."""
    return _resize_pil("lpr_resize_pil_bicubic", img, out_hw)


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG/PNG bytes -> (H, W, 3) uint8 RGB; None for bytes that are
    neither or do not decode."""
    lib = library("host_decode")
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = lib.lpr_decode_image(bytes(data), len(data), ctypes.byref(w),
                               ctypes.byref(h))
    if not ptr:
        return None
    try:
        buf = ctypes.cast(ptr, ctypes.POINTER(
            ctypes.c_uint8 * (w.value * h.value * 3))).contents
        return np.frombuffer(buf, np.uint8).reshape(
            h.value, w.value, 3).copy()
    finally:
        lib.lpr_free(ptr)


def load_letterbox_batch(paths: List[str], out_hw, fill: int = 0,
                         n_threads: int = 0) -> np.ndarray:
    """Decode + letterbox a batch of image files -> (N, oh, ow, 3) uint8,
    in parallel C++ (the native ``letterbox_into``'s geometry and taps, one
    file a thread; ``n_threads`` 0: one a core, at most
    :data:`MAX_THREADS`); a file that cannot be read or decoded leaves its
    slot ``fill``."""
    oh, ow = (int(v) for v in out_hw)
    n = len(paths)
    out = np.empty((n, oh, ow, 3), np.uint8)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    library("host_decode").lpr_load_letterbox_batch(
        arr, n, out.ctypes.data, oh, ow, int(fill), _threads(n_threads))
    return out


def _u8_image(img: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"{what}: expected a uint8 (H, W, C) image, got "
                         f"{img.dtype} {img.shape}")
    return img


def cv_resize_linear(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 (H, W, C) image, OpenCV's arithmetic in C
    (``csrc/host_augment.cc``)."""
    img = _u8_image(img, "cv_resize_linear")
    h, w, cn = img.shape
    out = np.empty((nh, nw, cn), np.uint8)
    if library("host_augment").lpr_cv_resize_linear(
            img.ctypes.data, h, w, cn, out.ctypes.data, nh, nw) != 0:
        raise ValueError(f"cv_resize_linear: bad sizes {img.shape} -> "
                         f"{(nh, nw)}")
    return out


def cv_warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                   border: int = 114) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize=(w, h), borderValue=(border,) * 3)``
    (INTER_LINEAR) of a uint8 (H, W, 3) image, m the forward 2x3 matrix
    (``csrc/host_augment.cc``)."""
    img = _u8_image(img, "cv_warp_affine")
    if img.shape[2] != 3:
        raise ValueError(f"cv_warp_affine: expected 3 channels, got "
                         f"{img.shape}")
    m = np.ascontiguousarray(np.asarray(m, np.float64)[:2, :3])
    ow, oh = int(dsize[0]), int(dsize[1])
    out = np.empty((oh, ow, 3), np.uint8)
    if library("host_augment").lpr_cv_warp_affine(
            img.ctypes.data, img.shape[0], img.shape[1], m.ctypes.data,
            out.ctypes.data, oh, ow, int(border)) != 0:
        raise ValueError(f"cv_warp_affine: bad sizes {img.shape} -> "
                         f"{(oh, ow)}")
    return out


def cv_hsv_lut(img: np.ndarray, lut_h: np.ndarray, lut_s: np.ndarray,
               lut_v: np.ndarray) -> np.ndarray:
    """``cvtColor(merge(LUT(h, lut_h), LUT(s, lut_s), LUT(v, lut_v)),
    HSV2RGB)`` of ``cvtColor(img, RGB2HSV)``: a new uint8 (H, W, 3) RGB
    image (``csrc/host_augment.cc``)."""
    out = _u8_image(img, "cv_hsv_lut").copy()
    if out.shape[2] != 3:
        raise ValueError(f"cv_hsv_lut: expected 3 channels, got {out.shape}")
    luts = [np.ascontiguousarray(l, np.uint8) for l in (lut_h, lut_s, lut_v)]
    if any(l.shape != (256,) for l in luts):
        raise ValueError("cv_hsv_lut: each table holds 256 uint8 entries")
    library("host_augment").lpr_cv_hsv_lut(
        out.ctypes.data, out.shape[0] * out.shape[1],
        *[l.ctypes.data for l in luts])
    return out
