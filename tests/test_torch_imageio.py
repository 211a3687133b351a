"""The port's image files without PIL (lpr_tpu_torch/imageio.py) against
PIL, its C copy of Pillow's bicubic resample against Pillow, and the uint8
conversions of ops/image.py against the JAX package's."""

import glob
import io
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lpr_tpu.ops import image as jim
from lpr_tpu_torch import imageio, native
from lpr_tpu_torch.ops import image as tim
from lpr_tpu_torch.tools import synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_PNGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "tests", "fixtures", "**", "*.png"), recursive=True))


def _pil_rgb(path_or_bytes):
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    return np.asarray(Image.open(src).convert("RGB"))


def _photo(hw, seed=0):
    """A smooth image with noise, so PIL's adaptive filters use every row
    filter."""
    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([120 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0)
                    for c in range(3)], -1) + rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def test_the_repo_has_its_fixture_pngs():
    assert len(REPO_PNGS) == 28


@pytest.mark.parametrize("rel", REPO_PNGS)
def test_read_rgb_matches_pil_on_every_repo_png(rel):
    path = os.path.join(ROOT, rel)
    np.testing.assert_array_equal(imageio.read_rgb(path), _pil_rgb(path))


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode,colour_type,depth", [
    ("L", 0, 8), ("RGB", 2, 8), ("P", 3, 8), ("LA", 4, 8), ("RGBA", 6, 8),
    ("1", 0, 1), ("P4", 3, 4), ("P2", 3, 2),
])
def test_read_rgb_matches_pil_on_every_colour_type(mode, colour_type, depth,
                                                   tmp_path):
    """PNGs that PIL writes in colour types 0, 2, 3, 4 and 6 (and gray and
    palette below 8 bits), every row filter among them, decode as PIL
    decodes them with alpha dropped."""
    rgb = Image.fromarray(_photo((37, 53)))
    if mode.startswith("P") and len(mode) > 1:
        img = rgb.quantize(colors=1 << depth)
    elif mode == "P":
        img = rgb.quantize(colors=256)
    elif mode in ("LA", "RGBA"):
        img = rgb.convert(mode)
        alpha = Image.fromarray(_photo((37, 53), seed=1)[..., 0])
        img.putalpha(alpha)
    else:
        img = rgb.convert(mode)
    data = _pil_png(img)
    ihdr = struct.unpack(">IIBBBBB", data[16:29])
    assert ihdr[2:4] == (depth, colour_type)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(imageio.read_rgb(str(path)),
                                  _pil_rgb(data))


def _with_ihdr(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (depth, interlace)."""
    w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          data[16:29])
    body = struct.pack(">IIBBBBB", w, h, fields.get("depth", depth), ctype,
                       comp, filt, fields.get("interlace", inter))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_16_bit_and_interlaced_pngs_raise(tmp_path):
    deep = Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999)
    data16 = _pil_png(deep)
    assert struct.unpack(">IIBB", data16[16:26])[2] == 16
    p16 = tmp_path / "deep.png"
    p16.write_bytes(data16)
    with pytest.raises(ValueError, match="16-bit"):
        imageio.read_rgb(str(p16))
    pil = tmp_path / "interlaced.png"
    pil.write_bytes(_with_ihdr(synth.png_bytes(_photo((8, 8))), interlace=1))
    with pytest.raises(ValueError, match="interlaced"):
        imageio.read_rgb(str(pil))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        imageio.read_rgb(str(bad))


def test_write_png_round_trips(tmp_path):
    img = _photo((31, 45), seed=3)
    path = tmp_path / "out.png"
    imageio.write_png(str(path), img)
    np.testing.assert_array_equal(imageio.read_rgb(str(path)), img)
    np.testing.assert_array_equal(_pil_rgb(str(path)), img)
    assert synth.png_bytes is imageio.png_bytes
    assert synth.write_png is imageio.write_png


def test_jpeg_goes_through_the_host_decoder(tmp_path, monkeypatch):
    """A JPEG decodes through native.decode_image (libjpeg, as PIL's own
    libjpeg decodes it here); where host_decode does not build, reading
    one raises with the build's message."""
    buf = io.BytesIO()
    Image.fromarray(_photo((40, 64))).save(buf, "JPEG", quality=90)
    path = tmp_path / "x.jpg"
    path.write_bytes(buf.getvalue())
    got = imageio.read_rgb(str(path))
    np.testing.assert_array_equal(got, native.decode_image(buf.getvalue()))
    np.testing.assert_array_equal(got, _pil_rgb(str(path)))

    def no_library(name):
        raise RuntimeError(f"g++ failed building {name}: fatal error: "
                           f"jpeglib.h: No such file or directory")

    monkeypatch.setattr(native, "library", no_library)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        imageio.read_rgb(str(path))


def test_list_images_filters_and_sorts(tmp_path):
    for name in ("b.PNG", "a.jpg", "c.jpeg", "d.bmp", "e.txt", "0.png"):
        (tmp_path / name).write_bytes(b"")
    assert imageio.list_images(str(tmp_path)) == ["0.png", "a.jpg", "b.PNG",
                                                  "c.jpeg"]


@pytest.mark.parametrize("src_hw,out_hw", [
    ((360, 640), (180, 320)), ((97, 151), (31, 40)),      # downscale
    ((43, 389), (32, 192)), ((292, 875), (32, 192)),      # the SR input
    ((360, 640), (720, 1280)), ((17, 23), (64, 50)),      # upscale
    ((32, 192), (50, 380)),                               # the panels
    ((1, 9), (5, 4)), ((7, 1), (1, 6)), ((13, 11), (1, 1)),  # 1-pixel edges
    ((40, 30), (40, 77)), ((40, 30), (19, 30)),           # one axis
])
def test_resize_pil_bicubic_matches_pillow(src_hw, out_hw):
    img = np.random.RandomState(5).randint(0, 256, (*src_hw, 3),
                                           dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(out_hw[::-1],
                                                 Image.BICUBIC))
    np.testing.assert_array_equal(native.resize_pil_bicubic(img, out_hw),
                                  ref)


def test_uint8_conversions_match_jax():
    """float_to_uint8 rounds half to even, as jnp.round does, and clips."""
    x = np.concatenate([np.arange(256, dtype=np.float32) / 255.0,
                        (np.arange(256, dtype=np.float32) + 0.5) / 255.0,
                        np.array([-0.3, 1.7, 0.5 / 255, 2.5 / 255],
                                 np.float32),
                        np.random.RandomState(0).rand(500).astype(
                            np.float32)])
    got = tim.float_to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jim.float_to_uint8(jnp.asarray(x))))
    u8 = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tim.uint8_to_float(torch.from_numpy(u8)).numpy(),
        np.asarray(jim.uint8_to_float(jnp.asarray(u8))))
