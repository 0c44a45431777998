"""BMP decode in numpy: what OpenCV's own ``BmpDecoder`` (``grfmt_bmp.cpp``)
gives through ``cv2.imdecode(IMREAD_COLOR)``, swapped to RGB.

- Headers: OS/2 v1 (12 bytes: 1, 4, 8, 24 and 32 bpp, 3-byte palette
  entries) and BITMAPINFOHEADER through v5 (40-124 bytes).
- Pixels: 1, 4 and 8 bpp through the palette (``biClrUsed`` entries, the
  rest of the 256 black); 16 bpp as 5-5-5 (``BI_RGB``, or ``BI_BITFIELDS``
  with 5-5-5 masks) or 5-6-5 (``BI_BITFIELDS``), each field shifted to the
  top of its byte, as OpenCV's ``icvCvt_BGR5552BGR``/``BGR5652BGR`` do;
  24 bpp; 32 bpp with its fourth byte dropped (``BI_RGB`` or
  ``BI_BITFIELDS``: OpenCV reads B, G, R from the first three bytes
  whatever the masks say). OpenCV reads ``BI_BITFIELDS`` masks from the
  12 bytes after the header, whatever the header's size.
- ``BI_RLE8`` and ``BI_RLE4`` with OpenCV's state machine: a run may not
  pass the end of its row, and the pixels that an end-of-line, end-of-bitmap
  or delta escape skips take palette entry 0. In ``BI_RLE4`` OpenCV moves
  an end of bitmap to the next row only and a delta only across: the rows
  a delta names are not skipped.
- Bottom-up rows, or top-down ones under a negative height.

What OpenCV refuses (other masks, other compressions or depths, a palette
of more than 256 entries, truncated pixel data, a bad RLE run) raises
``ValueError``. The decoder faces the network: the pixel data an
uncompressed header declares must be in the body before the image is
allocated.
"""

from __future__ import annotations

import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
# OpenCV's CV_IO_MAX_IMAGE_WIDTH and _HEIGHT
MAX_SIDE = 1 << 20


class _Header:
    def __init__(self, body: bytes):
        if len(body) < 26 or not body.startswith(b"BM"):
            raise ValueError("not a BMP image (no BM header)")
        self.offset, size = struct.unpack("<iI", body[10:18])
        self.compression = BI_RGB
        if size >= 36:
            if len(body) < 14 + 36:
                raise ValueError("truncated BMP header")
            (self.width, self.height, _, self.bpp, self.compression,
             clr_used) = struct.unpack("<iiHHI12xI", body[18:50])
            ok = self.width > 0 and self.height != 0 and (
                (self.bpp in (1, 4, 8, 24, 32) and self.compression == BI_RGB)
                or (self.bpp in (16, 32)
                    and self.compression in (BI_RGB, BI_BITFIELDS))
                or (self.bpp == 4 and self.compression == BI_RLE4)
                or (self.bpp == 8 and self.compression == BI_RLE8))
            if not ok:
                raise ValueError(f"BMP at {self.bpp} bpp with compression "
                                 f"{self.compression} is not supported")
            pos = 14 + size
            self.palette = np.zeros((256, 3), np.uint8)
            if self.bpp <= 8:
                if clr_used > 256:
                    raise ValueError(f"BMP palette of {clr_used} entries")
                n = clr_used or 1 << self.bpp
                pal = body[pos: pos + 4 * n]
                pal = pal[:len(pal) // 4 * 4]
                self.palette[:len(pal) // 4] = np.frombuffer(
                    pal, np.uint8).reshape(-1, 4)[:, 2::-1]
            elif self.bpp == 16 and self.compression == BI_BITFIELDS:
                if len(body) < pos + 12:
                    raise ValueError("truncated BMP bit-field masks")
                masks = struct.unpack("<III", body[pos: pos + 12])
                if masks == (0x7C00, 0x3E0, 0x1F):
                    self.bpp = 15
                elif masks != (0xF800, 0x7E0, 0x1F):
                    raise ValueError(f"BMP bit-field masks {masks} are not "
                                     f"5-5-5 or 5-6-5")
            elif self.bpp == 16:
                self.bpp = 15
        elif size == 12:
            self.width, self.height, _, self.bpp = struct.unpack(
                "<HHHH", body[18:26])
            if not (self.width > 0 and self.height != 0
                    and self.bpp in (1, 4, 8, 24, 32)):
                raise ValueError(f"OS/2 BMP at {self.bpp} bpp is not "
                                 f"supported")
            self.palette = np.zeros((256, 3), np.uint8)
            if self.bpp <= 8:
                n = 1 << self.bpp
                pal = body[26: 26 + 3 * n]
                pal = pal[:len(pal) // 3 * 3]
                self.palette[:len(pal) // 3] = np.frombuffer(
                    pal, np.uint8).reshape(-1, 3)[:, ::-1]
        else:
            raise ValueError(f"BMP info header of {size} bytes is not "
                             f"supported")
        self.top_down = self.height < 0
        self.height = abs(self.height)
        if self.offset < 0:
            raise ValueError("BMP pixel data offset is negative")


def decode_bmp_u8(body: bytes,
                  expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """BMP bytes -> (h, w, 3) uint8 RGB (see the module docstring). With
    ``expected_hw``, an image of another size is refused before its pixels
    are read."""
    hd = _Header(body)
    h, w = hd.height, hd.width
    if 3 * h * w >= 1 << 30 or max(h, w) > MAX_SIDE:
        raise ValueError(f"BMP of {h}x{w} is over OpenCV's limits (2^30 "
                         f"bytes, 2^20 a side)")
    if expected_hw is not None and (h, w) != tuple(expected_hw):
        raise ValueError(f"expected {expected_hw[0]}x{expected_hw[1]} LR "
                         f"input, got a {h}x{w} BMP")
    data = body[hd.offset:]
    if hd.compression in (BI_RLE8, BI_RLE4):
        idx = _rle(data, h, w, hd.bpp)
        rgb = hd.palette[idx]
    else:
        pitch = ((w * (16 if hd.bpp == 15 else hd.bpp) + 7) // 8 + 3) & -4
        if len(data) < h * pitch:
            raise ValueError(f"truncated BMP pixel data: {len(data)} of "
                             f"{h * pitch} bytes")
        rows = np.frombuffer(data, np.uint8, count=h * pitch).reshape(h, pitch)
        rgb = _pixels(rows, w, hd)
    return np.ascontiguousarray(rgb if hd.top_down else rgb[::-1])


def _pixels(rows: np.ndarray, w: int, hd: _Header) -> np.ndarray:
    """Uncompressed rows (in file order) -> (rows, w, 3) RGB."""
    if hd.bpp <= 8:
        if hd.bpp == 1:
            idx = np.unpackbits(rows, axis=1)
        elif hd.bpp == 4:
            idx = (rows[:, :, None] >> np.array([4, 0], np.uint8) & 15
                   ).reshape(rows.shape[0], -1)
        else:
            idx = rows
        return hd.palette[idx[:, :w]]
    if hd.bpp in (15, 16):
        t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
        if hd.bpp == 15:
            bgr = (t << 3, (t >> 2) & ~7, (t >> 7) & ~7)
        else:
            bgr = (t << 3, (t >> 3) & ~3, (t >> 8) & ~7)
        return np.stack(bgr[::-1], axis=-1).astype(np.uint8)
    n = hd.bpp // 8
    return rows[:, :n * w].reshape(rows.shape[0], w, n)[..., 2::-1]


def _rle(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """``BI_RLE8``/``BI_RLE4`` data -> (h, w) palette indices in file row
    order (bottom-up unless the height was negative), as OpenCV's
    ``BmpDecoder::readData`` walks it."""
    out = np.zeros(h * w, np.uint8)
    rle8 = bpp == 8
    y = x = pos = 0
    wrapped = 0           # RLE8: whether the last run ended its row

    def fill(count: int) -> None:
        """``FillUniColor``: palette entry 0 over ``count`` pixels from
        (y, x), on to the next row at each row's end."""
        nonlocal x, y
        while True:
            n = min(count, w - x)
            count -= n
            x += n             # entry 0 is already there
            if x >= w:
                x = 0
                y += 1
                if y >= h:
                    return
            if count <= 0:
                return

    try:
        while True:
            if pos + 2 > len(data):
                raise ValueError("truncated BMP RLE data")
            length, code = data[pos], data[pos + 1]
            pos += 2
            if length:                           # a run of one or two colours
                if x + length > w:
                    raise ValueError("BMP RLE run passes the end of its row")
                start = y * w + x
                if rle8:
                    out[start: start + length] = code
                    prev = y
                    x += length
                    if x >= w:
                        x, y = 0, y + 1
                    wrapped = y - prev
                    if y >= h:
                        break
                else:
                    out[start: start + length: 2] = code >> 4
                    out[start + 1: start + length: 2] = code & 15
                    x += length
            elif code > 2:                       # absolute mode
                if x + code > w:
                    raise ValueError("BMP RLE run passes the end of its row")
                start = y * w + x
                if rle8:
                    n = (code + 1) & ~1
                    raw = np.frombuffer(data, np.uint8, count=code,
                                        offset=pos)
                else:
                    n = (((code + 1) >> 1) + 1) & ~1
                    raw = np.frombuffer(data, np.uint8, count=(code + 1) >> 1,
                                        offset=pos)
                    raw = np.stack([raw >> 4, raw & 15], -1).reshape(-1)[:code]
                if pos + n > len(data):
                    raise ValueError("truncated BMP RLE data")
                out[start: start + code] = raw
                pos += n
                x += code
                wrapped = 0
            else:                                # end of line, bitmap; delta
                skip, rows = w - x, h - y
                if code == 2:
                    if pos + 2 > len(data):
                        raise ValueError("truncated BMP RLE data")
                    skip, rows = data[pos], data[pos + 1]
                    pos += 2
                if not rle8 or code or not wrapped or x > 0:
                    if rle8 and code:    # RLE4 skips no rows (OpenCV's)
                        skip += rows * w
                    if y >= h:
                        break
                    fill(skip)
                wrapped = 0
                if y >= h:
                    break
    except ValueError as e:
        raise ValueError(f"{e} (OpenCV refuses it too)") from None
    return out.reshape(h, w)
