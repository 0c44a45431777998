"""Sun raster in numpy: what OpenCV's ``SunRasterDecoder``
(``grfmt_sunras.cpp``) gives through ``cv2.imdecode(IMREAD_COLOR)``,
swapped to RGB.

- A 32-byte big-endian header: magic, width, height, depth, length
  (ignored), type, colour-map type, colour-map length.
- cv2 5.0.0 reads the old and standard types (0 and 1) only: the
  byte-encoded (RLE, 2) and RGB (3) types and any other are refused, as
  OpenCV refuses them (found on crafted files, its own ``.ras`` output
  relabelled included).
- Depths 1 and 8 through a colour map (``RMT_EQUAL_RGB``: the red, green
  and blue planes of ``length / 3`` entries, the rest of 256 black) or,
  without one, the gray ramp (0 and 255 at 1 bit, bit 1 white); depth 24
  as B, G, R bytes and 32 as X, B, G, R. A map on a deeper image, another
  map type, or a map longer than the depth allows is refused.
- Rows padded to 16 bits, most significant bit first at 1 bit.

What OpenCV refuses raises ``ValueError``; the data a header declares must
be in the body before the image is allocated.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"\x59\xa6\x6a\x95"
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30   # OpenCV's CV_IO_MAX_IMAGE_*


def decode_sunras_u8(body: bytes,
                     expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Sun raster bytes -> (h, w, 3) uint8 RGB."""
    if len(body) < 32 or not body.startswith(MAGIC):
        raise ValueError("not a Sun raster image (no 59a66a95 header)")
    w, h, depth, _, kind, maptype, maplen = struct.unpack(">7I", body[4:32])
    if depth not in (1, 8, 24, 32) or not w or not h:
        raise ValueError(f"Sun raster {w}x{h} at depth {depth} is not "
                         f"supported")
    if kind not in (0, 1):
        name = {2: "byte-encoded (RLE)", 3: "RGB"}.get(kind, str(kind))
        raise ValueError(f"Sun raster of type {name}: OpenCV reads the "
                         f"standard type only")
    if not (maptype == 0 and maplen == 0
            or maptype == 1 and 0 < maplen <= 3 << depth and depth <= 8):
        raise ValueError(f"Sun raster colour map of type {maptype}, "
                         f"{maplen} bytes, at depth {depth}")
    if w > MAX_SIDE or h > MAX_SIDE or w * h > MAX_PIXELS:
        raise ValueError(f"Sun raster {w}x{h} is too large")
    if expected_hw is not None and (h, w) != tuple(expected_hw):
        raise ValueError(f"image is {h}x{w}, expected "
                         f"{expected_hw[0]}x{expected_hw[1]}")
    pos = 32
    palette = np.zeros((256, 3), np.uint8)
    if maptype == 1:
        if len(body) < pos + maplen:
            raise ValueError("Sun raster colour map truncated")
        n = maplen // 3
        planes = np.frombuffer(body, np.uint8, 3 * n, pos).reshape(3, n)
        palette[:n] = planes.T
        pos += maplen
    elif depth == 1:
        palette[1] = 255
    elif depth == 8:
        palette[:] = np.arange(256, dtype=np.uint8)[:, None]
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    if len(body) - pos < pitch * h:
        raise ValueError("Sun raster pixel data truncated")
    rows = np.frombuffer(body, np.uint8, pitch * h, pos).reshape(h, pitch)
    if depth == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :w]]
    if depth == 8:
        return palette[rows[:, :w]]
    if depth == 24:
        return np.ascontiguousarray(
            rows[:, :3 * w].reshape(h, w, 3)[..., ::-1])
    return np.ascontiguousarray(rows.reshape(h, w, 4)[..., :0:-1])
