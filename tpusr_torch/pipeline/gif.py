"""GIF in numpy: what OpenCV 5's own ``GifDecoder`` (``grfmt_gif.cpp``)
gives through ``cv2.imdecode(IMREAD_COLOR)``, swapped to RGB: the first
frame of a GIF87a or GIF89a file on its logical screen.

Found by holding crafted files against cv2 5.0.0, where a reader would not
guess:

- The whole file is walked to its trailer first (OpenCV counts the
  frames): a file cut short anywhere, or without its trailer, is refused,
  and so is an application extension other than ``NETSCAPE2.0``, ``XMP
  DataXMP`` and ``ICCRGBG1012`` or a graphic control block of another
  size than 4; before the first frame, a disposal method past 3 too.
- One 256-entry colour table: a grey ramp (entry 1 white) where the file
  has none, the global table's entries over it, the first frame's local
  table over those. An index at or past the larger of the two tables'
  sizes (256 without tables) is refused.
- The screen is filled with the global table's background colour (black
  without a global table; a background index past the table is refused),
  the frame drawn at its offset (it must lie within the screen), its
  transparent index (Graphic Control Extension) left as background.
- LZW: codes of 3 to 12 bits, least significant first, across the
  sub-blocks; the end code acts as a clear code, codes are read until
  fewer bits remain than a code takes, a full table stays full until a
  clear; the frame must decode to exactly its width x height pixels, and
  once it has them, clear and end codes aside, only the data's last whole
  code may follow (and is dropped, whatever it is).
- Interlaced frames in the four passes of the specification.

What OpenCV refuses raises ``ValueError``; the screen size is checked
against ``expected_hw`` before anything is decoded.
"""

from __future__ import annotations

import struct

import numpy as np

MAX_PIXELS = 1 << 30                    # OpenCV's CV_IO_MAX_IMAGE_PIXELS
_APPLICATIONS = (b"NETSCAPE2.0", b"XMP DataXMP", b"ICCRGBG1012")


class _Stream:
    def __init__(self, body: bytes):
        self.body, self.pos = body, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.body):
            raise ValueError("GIF file truncated")
        b = self.body[self.pos:self.pos + n]
        self.pos += n
        return b

    def sub_blocks(self) -> bytes:
        out = []
        while True:
            n = self.take(1)[0]
            if not n:
                return b"".join(out)
            out.append(self.take(n))


def _table(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, np.uint8).reshape(-1, 3)


def _lzw(data: bytes, min_size: int, n: int) -> bytes:
    """The frame's ``n`` colour indices from its LZW codes."""
    if not 2 <= min_size <= 11:
        raise ValueError(f"GIF LZW minimum code size {min_size}")
    clear = 1 << min_size
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    width, prev = min_size + 1, None
    out = bytearray()
    acc = nb = pos = 0
    while True:
        while nb < width and pos < len(data):
            acc |= data[pos] << nb
            pos += 1
            nb += 8
        if nb < width:
            break
        code = acc & ((1 << width) - 1)
        acc >>= width
        nb -= width
        if code == clear or code == clear + 1:
            table = list(base)
            width, prev = min_size + 1, None
            continue
        if len(out) == n:
            # the frame is full: OpenCV drops one more code if it is the
            # last whole one in the data, and refuses any after it
            if nb + 8 * (len(data) - pos) >= width:
                raise ValueError("GIF frame data past its size")
            break
        nxt = len(table)
        if code < nxt:
            entry = table[code]
            if prev is not None and nxt < 4096:
                table.append(table[prev] + entry[:1])
        elif code == nxt and prev is not None:
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            raise ValueError(f"GIF LZW code {code} past its table")
        out += entry
        if len(out) > n:
            raise ValueError("GIF frame data past its size")
        if len(table) == 1 << width and width < 12:
            width += 1
        prev = code
    if len(out) != n:
        raise ValueError(f"GIF frame has {len(out)} of its {n} pixels")
    return bytes(out)


def decode_gif_u8(body: bytes,
                  expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """GIF bytes -> (h, w, 3) uint8 RGB of the first frame, as
    ``cv2.imdecode(IMREAD_COLOR)`` and the BGR->RGB swap give."""
    s = _Stream(body)
    if s.take(6) not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF image (no GIF87a/GIF89a header)")
    sw, sh, flags, bg, _ = struct.unpack("<HHBBB", s.take(7))
    if not sw or not sh or sw * sh >= MAX_PIXELS:
        raise ValueError(f"GIF screen {sw}x{sh} is not decodable")
    if expected_hw is not None and (sh, sw) != tuple(expected_hw):
        raise ValueError(f"image is {sh}x{sw}, expected "
                         f"{expected_hw[0]}x{expected_hw[1]}")
    colours = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    colours[1] = 255
    g_size = 0
    background = np.zeros(3, np.uint8)
    if flags & 0x80:
        g_size = 2 << (flags & 7)
        colours[:g_size] = _table(s.take(3 * g_size))
        if bg >= g_size:
            raise ValueError(f"GIF background index {bg} past its "
                             f"{g_size}-entry table")
        background = colours[bg].copy()
    first, transparent = None, None
    while True:
        kind = s.take(1)[0]
        if kind == 0x3B:                              # trailer
            break
        if kind == 0x21:                              # extension
            label = s.take(1)[0]
            if label == 0xFF:                         # application
                ident = s.take(s.take(1)[0])
                if ident not in _APPLICATIONS:
                    raise ValueError(f"GIF application extension "
                                     f"{ident[:16]!r}: OpenCV reads "
                                     f"NETSCAPE2.0, XMP and ICC ones only")
            elif label == 0xF9 and s.body[s.pos:s.pos + 1] != b"\x04":
                raise ValueError("GIF graphic control block not of 4 bytes")
            data = s.sub_blocks()
            if label == 0xF9 and first is None:
                if data[0] >> 2 & 7 > 3:
                    raise ValueError(f"GIF disposal method {data[0] >> 2 & 7}"
                                     f" before the first frame")
                transparent = data[3] if data[0] & 1 else None
        elif kind == 0x2C:                            # image
            x0, y0, w, h, f = struct.unpack("<HHHHB", s.take(9))
            local = s.take(3 * (2 << (f & 7))) if f & 0x80 else None
            min_size = s.take(1)[0]
            data = s.sub_blocks()
            if first is None:
                first = (x0, y0, w, h, f, local, min_size, data)
        else:
            raise ValueError(f"GIF block {kind:#04x} is not an extension, "
                             f"image or trailer")
    if first is None:
        raise ValueError("GIF file without a frame")
    x0, y0, w, h, f, local, min_size, data = first
    if not w or not h or x0 + w > sw or y0 + h > sh:
        raise ValueError("GIF frame outside its screen")
    limit = max(g_size, len(local) // 3 if local else 0) or 256
    if local:
        colours[:len(local) // 3] = _table(local)
    idx = np.frombuffer(_lzw(data, min_size, w * h), np.uint8).reshape(h, w)
    if f & 0x40:                                      # interlaced
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if int(idx.max()) >= limit:
        raise ValueError(f"GIF colour index {int(idx.max())} past its "
                         f"{limit}-entry table")
    out = np.empty((sh, sw, 3), np.uint8)
    out[:] = background
    frame = colours[idx]
    if transparent is not None:
        frame[idx == transparent] = background
    out[y0:y0 + h, x0:x0 + w] = frame
    return out
