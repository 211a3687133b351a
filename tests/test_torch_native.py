"""The port's host libraries (lpr_tpu_torch/native.py, csrc/host_*.cc) on
the CPU: decode and file letterbox against the JAX package's
native/lpr_native.cc (compiled here with g++ into a temporary directory and
loaded with ctypes, never through lpr_tpu.native, whose loader builds into
native/), the NHWC batch letterbox against its numpy reference, and the
bilinear resample against Pillow's BILINEAR."""

import ctypes
import io
import os
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from lpr_tpu_torch import native
from lpr_tpu_torch.kernels import _build
from lpr_tpu_torch.ops.image import (letterbox_geom, letterbox_host,
                                     letterbox_host_plain)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """native/lpr_native.cc built as native/Makefile builds it, into a
    temporary directory."""
    so = tmp_path_factory.mktemp("lpr_native") / "liblpr_native.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o",
                    str(so), os.path.join(ROOT, "native", "lpr_native.cc"),
                    "-ljpeg", "-lpng16", "-lpthread"], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.lpr_load_letterbox_batch.restype = ctypes.c_int
    lib.lpr_load_letterbox_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint8, ctypes.c_int]
    lib.lpr_decode_image.restype = ctypes.c_void_p
    lib.lpr_decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.lpr_free.argtypes = [ctypes.c_void_p]
    return lib


def _jax_decode(lib, data):
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = lib.lpr_decode_image(data, len(data), ctypes.byref(w),
                               ctypes.byref(h))
    if not ptr:
        return None
    buf = ctypes.cast(ptr, ctypes.POINTER(
        ctypes.c_uint8 * (w.value * h.value * 3))).contents
    arr = np.frombuffer(buf, np.uint8).reshape(h.value, w.value, 3).copy()
    lib.lpr_free(ptr)
    return arr


def _jax_load(lib, paths, oh, ow, fill):
    out = np.empty((len(paths), oh, ow, 3), np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    n_ok = lib.lpr_load_letterbox_batch(arr, len(paths), out.ctypes.data, oh,
                                        ow, fill, 2)
    return out, n_ok


def _encoded(img, fmt):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt,
                              **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _img(seed, hw):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3),
                                               dtype=np.uint8)


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_decode_image_matches_jax_native(jax_native, fmt):
    img = _img(0, (37, 53))
    data = _encoded(img, fmt)
    got = native.decode_image(data)
    np.testing.assert_array_equal(got, _jax_decode(jax_native, data))
    if fmt == "PNG":
        np.testing.assert_array_equal(got, img)
    assert native.decode_image(b"not an image") is None
    assert native.decode_image(data[:40]) is None    # truncated


@pytest.mark.parametrize("src_hw,out_hw", [((30, 64), (32, 64)),
                                           ((45, 70), (32, 64))],
                         ids=["pad-only", "resize"])
def test_load_letterbox_batch_matches_jax_native(jax_native, tmp_path,
                                                 src_hw, out_hw):
    """PNG and JPEG files and one missing file, letterboxed to out_hw:
    byte for byte the JAX package's native batch, the missing slot fill."""
    paths = []
    for i, fmt in enumerate(["PNG", "JPEG", "PNG"]):
        p = tmp_path / f"f{i}.{fmt.lower()}"
        p.write_bytes(_encoded(_img(i, src_hw), fmt))
        paths.append(str(p))
    paths.insert(2, str(tmp_path / "missing.png"))
    ref, n_ok = _jax_load(jax_native, paths, *out_hw, 7)
    assert n_ok == 3
    got = native.load_letterbox_batch(paths, out_hw, fill=7)
    np.testing.assert_array_equal(got, ref)
    assert (got[2] == 7).all()


@pytest.mark.parametrize("src_hw,det_hw", [
    ((720, 1280), (736, 1280)),     # pad-only: the production geometry
    ((60, 120), (64, 128)),
    ((37, 91), (64, 128)),
    ((50, 50), (64, 128)),
    ((64, 89), (32, 128)),          # int(x + 0.5) and round() disagree
    ((3, 200), (64, 128)),
])
def test_batch_letterbox_matches_plain_version(src_hw, det_hw):
    frames = np.random.RandomState(1).randint(0, 256, (3, *src_hw, 3),
                                              dtype=np.uint8)
    ref = letterbox_host_plain(frames, det_hw)
    np.testing.assert_array_equal(letterbox_host(frames, det_hw), ref)
    out = torch.full((3, *det_hw, 3), 99, dtype=torch.uint8)  # a host tensor
    assert letterbox_host(frames, det_hw, out=out) is out
    np.testing.assert_array_equal(out.numpy(), ref)
    for n_threads in (1, 5):
        got = np.full_like(ref, 99)
        _, (nh, nw), (left, top) = letterbox_geom(*src_hw, det_hw)
        native.letterbox_batch_into(frames, got, (nh, nw, top, left),
                                    n_threads=n_threads)
        np.testing.assert_array_equal(got, ref)


def test_batch_letterbox_takes_the_geometry_it_is_given():
    """At (64, 89) into (32, 128) the width scales to 44.5: letterbox_geom
    rounds half to even (44), the native letterbox_into int(x + 0.5) (45).
    The batch letterbox writes what the geometry it is given says."""
    _, (nh, nw), (left, top) = letterbox_geom(64, 89, (32, 128))
    assert (nh, nw) == (32, 44) and int(89 * 0.5 + 0.5) == 45
    frames = np.random.RandomState(2).randint(0, 256, (1, 64, 89, 3),
                                              dtype=np.uint8)
    out = np.full((1, 32, 128, 3), 5, np.uint8)
    native.letterbox_batch_into(frames, out, (nh, nw, top, left), fill=0)
    assert not out[:, :, :left].any() and not out[:, :, left + nw:].any()
    np.testing.assert_array_equal(out, letterbox_host_plain(frames,
                                                            (32, 128)))


def test_batch_letterbox_refuses_what_it_cannot_write():
    frames = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError):
        native.letterbox_batch_into(frames, np.zeros((2, 8, 8, 3), np.uint8),
                                    (8, 8, 1, 0))          # does not fit
    with pytest.raises(ValueError):
        native.letterbox_batch_into(frames, np.zeros((1, 8, 8, 3), np.uint8),
                                    (8, 8, 0, 0))          # wrong batch
    with pytest.raises(ValueError):
        native.letterbox_batch_into(
            frames, np.zeros((2, 8, 8, 3), np.float32), (8, 8, 0, 0))
    with pytest.raises(ValueError):
        native.letterbox_batch_into(frames.astype(np.float32),
                                    np.zeros((2, 8, 8, 3), np.uint8),
                                    (8, 8, 0, 0))


@pytest.mark.parametrize("src_hw,out_hw", [
    ((360, 640), (180, 320)), ((97, 151), (31, 40)),      # downscale
    ((360, 640), (720, 1280)), ((17, 23), (64, 50)),      # upscale
    ((1, 9), (5, 4)), ((7, 1), (1, 6)), ((13, 11), (1, 1)),  # 1-pixel edges
    ((40, 30), (40, 77)), ((40, 30), (19, 30)),           # one axis
])
def test_resize_pil_bilinear_matches_pillow(src_hw, out_hw):
    img = _img(3, src_hw)
    ref = np.asarray(Image.fromarray(img).resize(out_hw[::-1],
                                                 Image.BILINEAR))
    np.testing.assert_array_equal(native.resize_pil_bilinear(img, out_hw),
                                  ref)


def test_host_libraries_build_with_their_flags():
    """Every source builds with g++ (-ffp-contract=off), host_decode
    linked against libjpeg and libpng, and each library's name hashes its
    flags."""
    libs = _build.build_host()
    assert sorted(libs) == ["host_augment", "host_decode", "host_letterbox"]
    assert "-ffp-contract=off" in _build.host_command("host_letterbox", "x")
    assert _build.host_command("host_decode", "x")[-3:] == [
        "-ljpeg", "-lpng16", "-lpthread"]
    assert _build.missing_headers("host_decode") == []
    assert _build._target("host_letterbox", ".cc").parent == _build.BUILD_DIR


def test_batch_letterbox_takes_a_sequence_of_frames():
    """A list of (H, W, 3) frames (each its own array, as the server's
    batch) letterboxes and gathers as the stacked batch does."""
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (37, 91, 3), dtype=np.uint8)
              for _ in range(3)]
    frames.append(frames[-1])           # a padded batch repeats the last
    stacked = np.stack(frames)
    np.testing.assert_array_equal(letterbox_host(frames, (64, 128)),
                                  letterbox_host_plain(stacked, (64, 128)))
    out = np.zeros_like(stacked)
    native.gather_into(frames, out)
    np.testing.assert_array_equal(out, stacked)
    with pytest.raises(ValueError):
        native.gather_into(frames[:2] + [frames[0][:-1]], out[:3])
