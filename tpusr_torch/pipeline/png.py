"""PNG decode and encode in numpy and ``zlib``, for the HTTP tier and the
loaders.

The JAX package decodes and encodes with OpenCV
(``tpusr/pipeline/http_serving.py:29-47``); the port runs where no image
library is installed, so it carries its own codec:

- ``decode_png_u8``: any PNG that libpng reads, to what
  ``cv2.imdecode(IMREAD_COLOR)`` followed by the BGR->RGB swap gives: colour
  types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA) at
  every bit depth the format allows, plain or Adam7-interlaced, with all
  five row filters and the chunk CRCs checked. Alpha and ``tRNS`` are
  dropped, gray repeated into three channels, gray at 1, 2 or 4 bits scaled
  to 8 (libpng's ``png_set_expand_gray_1_2_4_to_8``), a palette index past
  its PLTE read as black, a 16-bit sample taken as its high byte (``>> 8``),
  and the eXIf chunk's orientation applied.
- ``encode_png``: 8-bit RGB (colour type 2), every row unfiltered (filter
  0), the IDAT compressed by ``zlib`` at level 1, after the JAX server's
  rounding ``clip(x * 255 + 0.5, 0, 255)``.

A body that is not a PNG raises ``ValueError``; ``pipeline/imdecode.py``
dispatches between this and the other formats.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tpusr_torch.pipeline.jpeg import (MAX_PIXELS, apply_orientation,
                                       exif_orientation)

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
ENCODE_LEVEL = 1


def _chunks(body: bytes):
    """(type, data) of each chunk after the signature, CRCs checked, up to
    and including IEND."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(body):
            raise ValueError("truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", body[pos: pos + 8])
        end = pos + 8 + length
        if end + 4 > len(body):
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        data = body[pos + 8: end]
        (crc,) = struct.unpack(">I", body[end: end + 4])
        if zlib.crc32(ctype + data) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos = end + 4


def _paeth_or_average_row(line: np.ndarray, prev: np.ndarray, bpp: int,
                          paeth: bool) -> np.ndarray:
    """Undo filter 4 (Paeth) or 3 (Average) on one row: each byte depends
    on the decoded byte ``bpp`` before it, so the row runs byte by byte."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if paeth:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The (height, stride) bytes of the image from its filtered scanlines."""
    need = height * (stride + 1)
    if len(raw) < need:
        raise ValueError(f"truncated PNG data: {len(raw)} of {need} bytes")
    data = np.frombuffer(raw, np.uint8, count=need).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        f, line = int(data[r, 0]), data[r, 1:]
        if f == 0:
            cur = line
        elif f == 1:     # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:     # Up
            cur = line + prev
        elif f in (3, 4):
            cur = _paeth_or_average_row(line, prev, bpp, paeth=f == 4)
        else:
            raise ValueError(f"PNG row {r} has the invalid filter type {f}")
        out[r] = cur
        prev = out[r]
    return out


def _passes(height: int, width: int, interlace: int):
    """(row0, col0, drow, dcol, rows, cols) of each pass of the image's
    data, the empty passes of a small Adam7 image left out."""
    grid = _ADAM7 if interlace else ((0, 0, 1, 1),)
    return [(y0, x0, dy, dx, -(-(height - y0) // dy), -(-(width - x0) // dx))
            for y0, x0, dy, dx in grid if height > y0 and width > x0]


def _samples(rows: np.ndarray, cols: int, ch: int, depth: int) -> np.ndarray:
    """A pass's unfiltered rows -> (rows, cols, ch) samples; 16-bit samples
    as their high byte, 1-, 2- and 4-bit ones as their values."""
    n = rows.shape[0]
    if depth == 16:      # big-endian samples: the high byte is >> 8
        return rows[:, :cols * ch * 2].reshape(n, cols, ch, 2)[..., 0]
    if depth == 8:
        return rows[:, :cols * ch].reshape(n, cols, ch)
    bits = np.unpackbits(rows, axis=1)[:, :cols * ch * depth]
    bits = bits.reshape(n, cols * ch, depth)
    vals = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
        -1, dtype=np.uint8)
    return vals.reshape(n, cols, ch)


def decode_png_u8(body: bytes,
                  expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """PNG bytes -> (h, w, 3) uint8 RGB (see the module docstring). With
    ``expected_hw``, an image of another size (in either orientation, since
    the eXIf tag may transpose it) is refused before its data is inflated;
    the data is inflated only as far as the image needs."""
    if not body.startswith(SIGNATURE):
        from tpusr_torch.pipeline.imdecode import image_format
        fmt = image_format(body)
        raise ValueError(f"a {fmt} image, not a PNG" if fmt else
                         "request body is not a decodable image (PNG expected)")
    header = palette = None
    idat = []
    orientation = 1
    for ctype, data in _chunks(body):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"eXIf" and orientation == 1:
            orientation = exif_orientation(data)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, color, comp, filt, interlace = header
    if color not in _CHANNELS or comp or filt or interlace > 1:
        raise ValueError(f"PNG colour type {color}, compression {comp}, "
                         f"filter method {filt}, interlace {interlace} is "
                         f"not a valid PNG")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"PNG bit depth {depth} in colour type {color} is "
                         f"not a valid PNG")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {height}x{width} is over 2^30 pixels "
                         f"(OpenCV's limit)")
    if expected_hw is not None and (height, width) not in (
            tuple(expected_hw), tuple(expected_hw)[::-1]):
        raise ValueError(f"expected {expected_hw[0]}x{expected_hw[1]} LR "
                         f"input, got a {height}x{width} PNG")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    passes = _passes(height, width, interlace)
    strides = [-(-cols * ch * depth // 8) for *_, cols in passes]
    need = sum(rows * (stride + 1)
               for (*_, rows, _c), stride in zip(passes, strides))
    try:
        z = zlib.decompressobj()
        raw = z.decompress(b"".join(idat), need)
        if len(raw) < need and not z.eof:
            raise zlib.error("incomplete or truncated stream")
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    if len(raw) < need:
        raise ValueError(f"truncated PNG data: {len(raw)} of {need} bytes")
    s = np.empty((height, width, ch), np.uint8)
    pos = 0
    for (y0, x0, dy, dx, rows, cols), stride in zip(passes, strides):
        part = _unfilter(raw[pos: pos + rows * (stride + 1)], rows, stride,
                         bpp)
        s[y0::dy, x0::dx] = _samples(part, cols, ch, depth)
        pos += rows * (stride + 1)
    if color == 3:       # libpng reads an index past the PLTE as black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        rgb = lut[s[..., 0]]
    else:
        if color == 0 and depth < 8:
            s = s * np.uint8(255 // ((1 << depth) - 1))
        rgb = (np.repeat(s[..., :1], 3, axis=-1) if color in (0, 4)
               else s[..., :3])
    return apply_orientation(rgb, orientation)


def decode_png(body: bytes) -> np.ndarray:
    """PNG bytes -> (h, w, 3) float32 RGB in [0, 1]."""
    return decode_png_u8(body).astype(np.float32) / 255.0


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data)))


def encode_png_u8(u8: np.ndarray) -> bytes:
    """(h, w, 3) uint8 RGB -> 8-bit RGB PNG bytes."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    if u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"encode_png: expected (h, w, 3), got {u8.shape}")
    h, w, _ = u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)],
                          axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ENCODE_LEVEL))
            + _chunk(b"IEND", b""))


def encode_png(rgb01: np.ndarray) -> bytes:
    """(h, w, 3) RGB in [0, 1] -> PNG bytes, rounded as the JAX server
    rounds: ``clip(x * 255 + 0.5, 0, 255)`` then a truncating uint8 cast."""
    u8 = np.clip(np.asarray(rgb01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return encode_png_u8(u8)
