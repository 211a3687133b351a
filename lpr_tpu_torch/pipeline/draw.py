"""Drawing on uint8 RGB images in numpy, for the annotated frames and
report panels (the JAX package draws them with PIL).

- :func:`draw_rect` — an outline with PIL's ``ImageDraw.rectangle(xy,
  outline=, width=)`` geometry: the corners are inclusive and the outline
  grows inward.
- :func:`draw_text`, :func:`text_box` — text in the 5x7 bitmap font below,
  each glyph in a 6x8 cell scaled by a whole factor chosen from a point
  size (:func:`text_scale`), the cell's top left at the given point.  The
  JAX package renders DejaVu Sans Mono Bold with FreeType, which needs PIL
  or freetype; the port carries its own font instead, so text pixels
  differ from the JAX images while positions, colours and everything
  outside the text do not.  Characters outside printable ASCII draw as
  ``?``.
- :func:`paste` — an image placed at a point, clipped to the canvas.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

# Printable ASCII, 32 (space) to 126 (~): 7 rows of 5 columns each, "#"
# for ink.
_GLYPHS = {
    " ": "..... ..... ..... ..... ..... ..... .....",
    "!": "..#.. ..#.. ..#.. ..#.. ..#.. ..... ..#..",
    '"': ".#.#. .#.#. .#.#. ..... ..... ..... .....",
    "#": ".#.#. .#.#. ##### .#.#. ##### .#.#. .#.#.",
    "$": "..#.. .#### #.#.. .###. ..#.# ####. ..#..",
    "%": "##... ##..# ...#. ..#.. .#... #..## ...##",
    "&": ".##.. #..#. #.#.. .#... #.#.# #..#. .##.#",
    "'": "..#.. ..#.. .#... ..... ..... ..... .....",
    "(": "...#. ..#.. .#... .#... .#... ..#.. ...#.",
    ")": ".#... ..#.. ...#. ...#. ...#. ..#.. .#...",
    "*": "..... ..#.. #.#.# .###. #.#.# ..#.. .....",
    "+": "..... ..#.. ..#.. ##### ..#.. ..#.. .....",
    ",": "..... ..... ..... ..... .##.. ..#.. .#...",
    "-": "..... ..... ..... ##### ..... ..... .....",
    ".": "..... ..... ..... ..... ..... .##.. .##..",
    "/": "..... ....# ...#. ..#.. .#... #.... .....",
    "0": ".###. #...# #..## #.#.# ##..# #...# .###.",
    "1": "..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.",
    "2": ".###. #...# ....# ...#. ..#.. .#... #####",
    "3": "##### ...#. ..#.. ...#. ....# #...# .###.",
    "4": "...#. ..##. .#.#. #..#. ##### ...#. ...#.",
    "5": "##### #.... ####. ....# ....# #...# .###.",
    "6": "..##. .#... #.... ####. #...# #...# .###.",
    "7": "##### ....# ...#. ..#.. .#... .#... .#...",
    "8": ".###. #...# #...# .###. #...# #...# .###.",
    "9": ".###. #...# #...# .#### ....# ...#. .##..",
    ":": "..... .##.. .##.. ..... .##.. .##.. .....",
    ";": "..... .##.. .##.. ..... .##.. ..#.. .#...",
    "<": "...#. ..#.. .#... #.... .#... ..#.. ...#.",
    "=": "..... ..... ##### ..... ##### ..... .....",
    ">": ".#... ..#.. ...#. ....# ...#. ..#.. .#...",
    "?": ".###. #...# ....# ...#. ..#.. ..... ..#..",
    "@": ".###. #...# ....# .##.# #.#.# #.#.# .###.",
    "A": ".###. #...# #...# ##### #...# #...# #...#",
    "B": "####. #...# #...# ####. #...# #...# ####.",
    "C": ".###. #...# #.... #.... #.... #...# .###.",
    "D": "###.. #..#. #...# #...# #...# #..#. ###..",
    "E": "##### #.... #.... ####. #.... #.... #####",
    "F": "##### #.... #.... ####. #.... #.... #....",
    "G": ".###. #...# #.... #.### #...# #...# .####",
    "H": "#...# #...# #...# ##### #...# #...# #...#",
    "I": ".###. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "J": "..### ...#. ...#. ...#. ...#. #..#. .##..",
    "K": "#...# #..#. #.#.. ##... #.#.. #..#. #...#",
    "L": "#.... #.... #.... #.... #.... #.... #####",
    "M": "#...# ##.## #.#.# #.#.# #...# #...# #...#",
    "N": "#...# #...# ##..# #.#.# #..## #...# #...#",
    "O": ".###. #...# #...# #...# #...# #...# .###.",
    "P": "####. #...# #...# ####. #.... #.... #....",
    "Q": ".###. #...# #...# #...# #.#.# #..#. .##.#",
    "R": "####. #...# #...# ####. #.#.. #..#. #...#",
    "S": ".#### #.... #.... .###. ....# ....# ####.",
    "T": "##### ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "U": "#...# #...# #...# #...# #...# #...# .###.",
    "V": "#...# #...# #...# #...# #...# .#.#. ..#..",
    "W": "#...# #...# #...# #.#.# #.#.# #.#.# .#.#.",
    "X": "#...# #...# .#.#. ..#.. .#.#. #...# #...#",
    "Y": "#...# #...# .#.#. ..#.. ..#.. ..#.. ..#..",
    "Z": "##### ....# ...#. ..#.. .#... #.... #####",
    "[": ".###. .#... .#... .#... .#... .#... .###.",
    "\\": "..... #.... .#... ..#.. ...#. ....# .....",
    "]": ".###. ...#. ...#. ...#. ...#. ...#. .###.",
    "^": "..#.. .#.#. #...# ..... ..... ..... .....",
    "_": "..... ..... ..... ..... ..... ..... #####",
    "`": ".#... ..#.. ...#. ..... ..... ..... .....",
    "a": "..... ..... .###. ....# .#### #...# .####",
    "b": "#.... #.... #.##. ##..# #...# #...# ####.",
    "c": "..... ..... .###. #.... #.... #...# .###.",
    "d": "....# ....# .##.# #..## #...# #...# .####",
    "e": "..... ..... .###. #...# ##### #.... .###.",
    "f": "..##. .#..# .#... ###.. .#... .#... .#...",
    "g": "..... .#### #...# #...# .#### ....# .###.",
    "h": "#.... #.... #.##. ##..# #...# #...# #...#",
    "i": "..#.. ..... .##.. ..#.. ..#.. ..#.. .###.",
    "j": "...#. ..... ..##. ...#. ...#. #..#. .##..",
    "k": "#.... #.... #..#. #.#.. ##... #.#.. #..#.",
    "l": ".##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "m": "..... ..... ##.#. #.#.# #.#.# #...# #...#",
    "n": "..... ..... #.##. ##..# #...# #...# #...#",
    "o": "..... ..... .###. #...# #...# #...# .###.",
    "p": "..... ..... ####. #...# ####. #.... #....",
    "q": "..... ..... .##.# #..## .#### ....# ....#",
    "r": "..... ..... #.##. ##..# #.... #.... #....",
    "s": "..... ..... .###. #.... .###. ....# ####.",
    "t": ".#... .#... ###.. .#... .#... .#..# ..##.",
    "u": "..... ..... #...# #...# #...# #..## .##.#",
    "v": "..... ..... #...# #...# #...# .#.#. ..#..",
    "w": "..... ..... #...# #...# #.#.# #.#.# .#.#.",
    "x": "..... ..... #...# .#.#. ..#.. .#.#. #...#",
    "y": "..... ..... #...# #...# .#### ....# .###.",
    "z": "..... ..... ##### ...#. ..#.. .#... #####",
    "{": "...#. ..#.. ..#.. .#... ..#.. ..#.. ...#.",
    "|": "..#.. ..#.. ..#.. ..#.. ..#.. ..#.. ..#..",
    "}": ".#... ..#.. ..#.. ...#. ..#.. ..#.. .#...",
    "~": "..... ..... .#... #.#.# ...#. ..... .....",
}
CELL_W, CELL_H = 6, 8       # a 5x7 glyph, one column and one row of space

Color = Tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def _cells() -> dict:
    """Each glyph's (CELL_H, CELL_W) bool cell."""
    out = {}
    for ch, rows in _GLYPHS.items():
        cell = np.zeros((CELL_H, CELL_W), bool)
        cell[:7, :5] = [[c == "#" for c in r] for r in rows.split()]
        out[ch] = cell
    return out


def text_scale(size: int) -> int:
    """The whole factor of the 6x8 cell for a point size: the cell's
    height nearest to the size, at least one."""
    return max(1, round(size / CELL_H))


def text_mask(text: str, size: int) -> np.ndarray:
    """(h, w) bool ink of ``text`` at ``size``."""
    cells = _cells()
    s = text_scale(size)
    if not text:
        return np.zeros((CELL_H * s, 0), bool)
    row = np.concatenate([cells.get(c, cells["?"]) for c in text], 1)
    return row.repeat(s, 0).repeat(s, 1)


def text_box(xy: Tuple[int, int], text: str, size: int
             ) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1), exclusive ends, of ``text`` drawn at ``xy``."""
    s = text_scale(size)
    x, y = int(xy[0]), int(xy[1])
    return x, y, x + CELL_W * s * len(text), y + CELL_H * s


def _window(img_shape, x: int, y: int, h: int, w: int):
    """The part of an (h, w) patch at (x, y) inside an image: (image
    slices, patch slices), or None when nothing is inside."""
    ih, iw = img_shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, ih), min(x + w, iw)
    if y1 <= y0 or x1 <= x0:
        return None
    return ((slice(y0, y1), slice(x0, x1)),
            (slice(y0 - y, y1 - y), slice(x0 - x, x1 - x)))


def draw_text(img: np.ndarray, xy: Tuple[int, int], text: str,
              color: Color, size: int) -> None:
    """Draw ``text`` in place on (H, W, 3) uint8 ``img``, the cell's top
    left at ``xy``, clipped to the image."""
    mask = text_mask(text, size)
    win = _window(img.shape, int(xy[0]), int(xy[1]), *mask.shape)
    if win is None:
        return
    dst, src = win
    img[dst][mask[src]] = color


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int,
          color: Color) -> None:
    """Rows y0..y1-1, columns x0..x1-1 set to ``color``, clipped."""
    h, w = img.shape[:2]
    y0, y1, x0, x1 = max(y0, 0), min(y1, h), max(x0, 0), min(x1, w)
    if y0 < y1 and x0 < x1:
        img[y0:y1, x0:x1] = color


def draw_rect(img: np.ndarray, box: Sequence[int], color: Color,
              width: int = 1) -> None:
    """Outline (x0, y0, x1, y1), corners inclusive, ``width`` pixels wide
    and growing inward, in place, clipped to the image: Pillow's
    ``ImagingDrawRectangle``, ring by ring, a full row at y0 + i and at
    y1 - i and a column at x0 + i and at x1 - i from y0 + width up to,
    not including, y1 - width + 1 (in either direction, so a box thinner
    than two widths draws those columns outside it, as Pillow does)."""
    x0, y0, x1, y1 = (int(v) for v in box)
    width = max(int(width), 1)
    ya, yb = y0 + width, y1 - width + 1
    col = (ya, yb) if ya <= yb else (yb + 1, ya + 1)
    for i in range(width):
        _fill(img, y0 + i, y0 + i + 1, x0, x1 + 1, color)
        _fill(img, y1 - i, y1 - i + 1, x0, x1 + 1, color)
        _fill(img, *col, x1 - i, x1 - i + 1, color)
        _fill(img, *col, x0 + i, x0 + i + 1, color)


def paste(img: np.ndarray, patch: np.ndarray, xy: Tuple[int, int]) -> None:
    """Place ``patch`` (h, w, 3) uint8 with its top left at ``xy``, in
    place, clipped to the image."""
    win = _window(img.shape, int(xy[0]), int(xy[1]), *patch.shape[:2])
    if win is None:
        return
    dst, src = win
    img[dst] = patch[src]
