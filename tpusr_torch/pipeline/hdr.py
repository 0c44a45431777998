"""Radiance HDR and PFM in numpy: what OpenCV's ``HdrDecoder`` (Bruce
Walter's ``rgbe`` reader) and ``PFMDecoder`` give through
``cv2.imdecode(IMREAD_COLOR)``, swapped to RGB.

HDR (``#?RADIANCE`` or ``#?RGBE``):

- The header as ``RGBE_ReadHeader`` reads it with ``fgets`` into 128
  bytes (a longer line is read in pieces of 127): lines up to
  ``FORMAT=32-bit_rle_rgbe``, a blank line (an earlier one is an error),
  then ``-Y <height> +X <width>`` as ``sscanf`` matches it. The pixels
  start after that line.
- Pixels: at widths 8-32767 each scanline is new-style RLE (``2 2`` and
  the width, then the R, G, B and E planes in runs and literals) until a
  scanline does not start so, from which pixel on the rest of the image is
  read flat; other widths are flat. A run or literal past its plane, a
  zero count or a short file is refused.
- ``rgbe2float``: ``c * 2**(e - 136)`` for ``e`` > 0, else 0; then
  ``convertTo(CV_8U, 255)``: the float times 255, rounded half to even,
  saturated, and 0 where the value leaves int32 (``cvRound``'s
  ``0x80000000``).

PFM (``PF`` colour or ``Pf`` gray, then a line break): width, height and
scale, each ended by one whitespace byte and read as C's ``atoi`` and
``atof`` read them (the longest number at the front, else 0); little-endian
when the scale is
negative, big-endian otherwise; rows from the bottom up; each value times
``1 / |scale|`` in float32, then ``convertTo(CV_8U)`` with no factor of
255 (rounded and saturated as above). A scale of 0 is refused. Under
``IMREAD_COLOR`` OpenCV returns ``Pf`` with one channel; the JAX server's
``cvtColor`` repeats it into three, as the port does.

What OpenCV refuses raises ``ValueError``; sizes are checked against the
body and ``expected_hw`` before anything is allocated.
"""

from __future__ import annotations

import re

import numpy as np

MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30   # OpenCV's CV_IO_MAX_IMAGE_*
# the prefixes C's atoi and atof read
_C_INT = re.compile(rb"[+-]?\d+")
_C_FLOAT = re.compile(rb"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
                      rb"|(?i:inf(?:inity)?|nan))")
_TOKEN = re.compile(rb"[^ \t\n\v\f\r]*[ \t\n\v\f\r]")
_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*([+-]?\d+)[ \t\n\v\f\r]*\+X"
                   rb"[ \t\n\v\f\r]*([+-]?\d+)")


def _check_size(w: int, h: int, expected_hw):
    if w <= 0 or h <= 0 or w > MAX_SIDE or h > MAX_SIDE \
            or w * h > MAX_PIXELS:
        raise ValueError(f"image {w}x{h} is not decodable")
    if expected_hw is not None and (h, w) != tuple(expected_hw):
        raise ValueError(f"image is {h}x{w}, expected "
                         f"{expected_hw[0]}x{expected_hw[1]}")


def to_u8(v: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>(cvRound(v))`` of float32 values."""
    v = np.asarray(v, np.float32)
    with np.errstate(invalid="ignore"):
        ok = (v >= -2.0 ** 31) & (v < 2.0 ** 31)      # NaN fails both
    r = np.where(ok, np.rint(np.where(ok, v, 0)), 0)
    return np.clip(r, 0, 255).astype(np.uint8)


def _fgets(body: bytes, pos: int):
    """One ``fgets(buf, 128)``: (piece, position after), or (None, pos)
    at the end."""
    if pos >= len(body):
        return None, pos
    nl = body.find(b"\n", pos, pos + 127)
    end = nl + 1 if nl >= 0 else min(pos + 127, len(body))
    return body[pos:end], end


def _rgbe_header(body: bytes):
    line, pos = _fgets(body, 0)
    while line != b"FORMAT=32-bit_rle_rgbe\n":
        if line is None:
            raise ValueError("HDR header truncated")
        if line[:1] in (b"", b"\n", b"\x00"):
            raise ValueError("HDR header without FORMAT=32-bit_rle_rgbe")
        line, pos = _fgets(body, pos)
    line, pos = _fgets(body, pos)
    if line != b"\n":
        raise ValueError("HDR header: no blank line after its FORMAT")
    line, pos = _fgets(body, pos)
    m = _SIZE.match(line or b"")
    if m is None:
        raise ValueError("HDR header without '-Y <height> +X <width>'")
    return int(m.group(2)), int(m.group(1)), pos


def _flat(body: bytes, pos: int, n: int) -> np.ndarray:
    if len(body) - pos < 4 * n:
        raise ValueError("HDR pixel data truncated")
    return np.frombuffer(body, np.uint8, 4 * n, pos).reshape(n, 4)


def _rle_pixels(body: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """RGBE_ReadPixels_RLE -> (h * w, 4) uint8 RGBE."""
    if w < 8 or w > 0x7FFF:
        return _flat(body, pos, w * h)
    out = np.empty((h * w, 4), np.uint8)
    n = len(body)
    for y in range(h):
        if n - pos < 4:
            raise ValueError("HDR pixel data truncated")
        head = body[pos:pos + 4]
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
            out[y * w:] = _flat(body, pos, (h - y) * w)
            return out
        if (head[2] << 8 | head[3]) != w:
            raise ValueError("HDR scanline of another width")
        pos += 4
        line = bytearray(4 * w)
        p = 0
        for c in range(4):
            end = (c + 1) * w
            while p < end:
                if n - pos < 2:
                    raise ValueError("HDR pixel data truncated")
                count, v = body[pos], body[pos + 1]
                if count > 128:
                    count -= 128
                    if count > end - p:
                        raise ValueError("HDR run past its scanline")
                    line[p:p + count] = bytes([v]) * count
                    p += count
                    pos += 2
                else:
                    if count == 0 or count > end - p:
                        raise ValueError("HDR bad scanline data")
                    if n - pos < 1 + count:
                        raise ValueError("HDR pixel data truncated")
                    line[p:p + count] = body[pos + 1:pos + 1 + count]
                    p += count
                    pos += 1 + count
        out[y * w:(y + 1) * w] = np.frombuffer(bytes(line), np.uint8) \
            .reshape(4, w).T
    return out


def decode_hdr_u8(body: bytes,
                  expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Radiance HDR bytes -> (h, w, 3) uint8 RGB."""
    if not body.startswith((b"#?RADIANCE", b"#?RGBE")):
        raise ValueError("not a Radiance HDR image (no #?RADIANCE/#?RGBE)")
    w, h, pos = _rgbe_header(body)
    _check_size(w, h, expected_hw)
    rgbe = _rle_pixels(body, pos, w, h)
    e = rgbe[:, 3].astype(np.int64)
    f = np.where(e > 0, np.ldexp(np.float32(1), (e - 136).astype(np.int32)),
                 0).astype(np.float32)
    v = rgbe[:, :3].astype(np.float32) * f[:, None]
    with np.errstate(over="ignore"):                 # inf: to_u8 gives 0
        v = v * np.float32(255)
    return to_u8(v).reshape(h, w, 3)


def _pfm_token(body: bytes, pos: int):
    """``read_number``'s characters up to one whitespace byte."""
    m = _TOKEN.match(body, pos)
    if m is None:
        raise ValueError("PFM header truncated")
    return m.group()[:-1], m.end()


def decode_pfm_u8(body: bytes,
                  expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """PFM bytes -> (h, w, 3) uint8 RGB (gray repeated)."""
    if body[:3] not in (b"PF\n", b"Pf\n"):
        raise ValueError("not a PFM image (no PF/Pf line)")
    nch = 3 if body[1:2] == b"F" else 1
    pos = 3
    tokens = []
    for _ in range(3):
        tok, pos = _pfm_token(body, pos)
        tokens.append(tok)
    if any(b >= 0x80 for t in tokens for b in t):
        raise ValueError("PFM header holds a byte past ASCII")
    m = [_C_INT.match(tokens[0]), _C_INT.match(tokens[1]),
         _C_FLOAT.match(tokens[2])]
    w, h = (int(x.group()) if x else 0 for x in m[:2])
    scale = float(m[2].group().lower().replace(b"infinity", b"inf")) \
        if m[2] else 0.0
    _check_size(w, h, expected_hw)
    if not abs(scale) > 0:
        raise ValueError(f"PFM scale {scale}")
    n = w * h * nch
    if len(body) - pos < 4 * n:
        raise ValueError("PFM data truncated")
    v = np.frombuffer(body, "<f4" if scale < 0 else ">f4", n, pos) \
        .reshape(h, w, nch)[::-1].astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        v = v * np.float32(1.0 / abs(scale))
    out = to_u8(v)
    return np.repeat(out, 3, 2) if nch == 1 else out
