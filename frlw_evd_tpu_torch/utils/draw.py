"""The OpenCV drawing pieces the port's renderers use, in numpy, so that
no module of the port needs cv2 (the card's machine has none). Images are
host uint8 (H, W, 3) BGR arrays, as cv2's are, and (H, W) for gray.

  * `COLORMAP_JET`, `COLORMAP_HSV`: 256 x 3 BGR lookup tables made from
    their formulas (JET piecewise linear in steps of 4 levels; HSV
    Octave's hsv(64), interpolated linearly to 256 levels, as OpenCV
    builds it); `apply_colormap` maps a uint8 image through one;
  * `rectangle`: a one-pixel outline, clipped to the image
    (cv2.rectangle(img, pt1, pt2, color, 1));
  * `resize_nearest`: cv2.resize(..., INTER_NEAREST)'s index rule,
    source index floor(dst_i * (1 / (dst / src)));
  * `write_png`, `read_png`: 8-bit gray or BGR PNG on zlib and struct,
    every row filter 0;
  * `put_text`: a label in a built-in 3 x 5 bitmap font, its baseline at
    `org` (cv2.putText's Hershey glyphs are not reproduced).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _jet() -> np.ndarray:
    i = np.arange(256)
    ramp = lambda lo, hi: np.clip(np.minimum(4 * i - lo, hi - 4 * i),  # noqa: E731
                                  0, 255)
    r, g, b = ramp(382, 1148), ramp(128, 892), ramp(-128, 638)
    return np.stack([b, g, r], 1).astype(np.uint8)


def _hsv() -> np.ndarray:
    h = np.linspace(0.0, 1.0, 64) * 6.0
    sector = np.minimum(np.floor(h), 5).astype(int)
    f = h - sector
    f[-1] = 1.0                       # hue 1 is hue 0: red
    one, zero = np.ones(64), np.zeros(64)
    rgb = {0: (one, f, zero), 1: (1 - f, one, zero), 2: (zero, one, f),
           3: (zero, 1 - f, one), 4: (f, zero, one), 5: (one, zero, 1 - f)}
    base = np.zeros((64, 3))
    for s, (r, g, b) in rgb.items():
        m = sector == s
        base[m] = np.stack([r[m], g[m], b[m]], 1)
    base[-1] = (1.0, 0.0, 0.0)
    x = np.linspace(0.0, 1.0, 256)
    lut = np.stack([np.interp(x, np.linspace(0.0, 1.0, 64), base[:, c])
                    for c in (2, 1, 0)], 1)
    return np.round(lut * 255.0).astype(np.uint8)


COLORMAP_JET = _jet()
COLORMAP_HSV = _hsv()


def apply_colormap(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """(H, W) uint8 → (H, W, 3) uint8 BGR through a 256 x 3 table."""
    return lut[np.asarray(img, np.uint8)]


def rectangle(img: np.ndarray, pt1, pt2, color) -> np.ndarray:
    """Draw the one-pixel outline of the rectangle with corners pt1, pt2
    ((x, y) ints, inclusive, either order) in `color` in place; the parts
    outside the image are dropped. Returns img."""
    H, W = img.shape[:2]
    x1, x2 = sorted((int(pt1[0]), int(pt2[0])))
    y1, y2 = sorted((int(pt1[1]), int(pt2[1])))
    color = np.asarray(color, img.dtype)
    xa, xb = max(x1, 0), min(x2, W - 1)
    ya, yb = max(y1, 0), min(y2, H - 1)
    if xa <= xb:
        for y in (y1, y2):
            if 0 <= y < H:
                img[y, xa:xb + 1] = color
    if ya <= yb:
        for x in (x1, x2):
            if 0 <= x < W:
                img[ya:yb + 1, x] = color
    return img


def nearest_indices(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index of each of `dst` outputs."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                      src - 1)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST), size (w, h)
    as cv2 takes it."""
    w, h = size
    return img[nearest_indices(img.shape[0], h)][:, nearest_indices(
        img.shape[1], w)]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> str:
    """Write an (H, W) gray or (H, W, 3) BGR uint8 image as an 8-bit PNG
    (RGB on disk, as cv2.imwrite writes a BGR array), filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    H, W = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = img if img.ndim == 2 else img[..., ::-1]
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          np.ascontiguousarray(rows).reshape(H, -1)], 1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return path


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray or RGB PNG as write_png writes it (not interlaced,
    every row filter 0) as (H, W) or (H, W, 3) BGR uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    W, H, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in (0, 2) or interlace:
        raise ValueError(f"{path}: only 8-bit gray / RGB, not interlaced")
    ch = 1 if color_type == 0 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(
        H, 1 + W * ch)
    if raw[:, 0].any():
        raise ValueError(f"{path}: only filter 0 rows are read")
    rows = raw[:, 1:].copy()
    return rows.reshape(H, W) if ch == 1 else rows.reshape(H, W, 3)[..., ::-1]


# 3 x 5 glyphs, one string of 15 bits a character, row by row
_FONT = {
    "a": "000011101111011", "b": "100110101101110", "c": "000011100100011",
    "d": "001011101101011", "e": "000111111100011", "f": "011100110100100",
    "g": "011101011001110", "h": "100110101101101", "i": "010000010010010",
    "j": "001000001101010", "k": "100101110101101", "l": "110010010010111",
    "m": "000111111101101", "n": "000110101101101", "o": "000010101101010",
    "p": "000110101110100", "q": "000011101011001", "r": "000011100100100",
    "s": "000011110011110", "t": "010111010010011", "u": "000101101101011",
    "v": "000101101101010", "w": "000101101111111", "x": "000101010101101",
    "y": "101101011001110", "z": "000111011110111",
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111", ".": "000000000000010", "-": "000000111000000",
    " ": "000000000000000",
}
GLYPH_W, GLYPH_H = 3, 5


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """Draw `text` in place in the 3 x 5 bitmap font (one pixel between
    glyphs; letters as lower case, unknown characters blank), the bottom
    left of the first glyph at org (x, y), clipped to the image. Returns
    img."""
    H, W = img.shape[:2]
    color = np.asarray(color, img.dtype)
    x0, y0 = int(org[0]), int(org[1]) - GLYPH_H + 1
    for n, ch in enumerate(text.lower()):
        bits = _FONT.get(ch, _FONT[" "])
        for k, bit in enumerate(bits):
            y, x = y0 + k // GLYPH_W, x0 + n * (GLYPH_W + 1) + k % GLYPH_W
            if bit == "1" and 0 <= y < H and 0 <= x < W:
                img[y, x] = color
    return img
