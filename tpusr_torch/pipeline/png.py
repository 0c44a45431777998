"""PNG decode and encode in numpy and ``zlib``, for the HTTP tier.

The JAX package's server decodes and encodes with OpenCV
(``tpusr/pipeline/http_serving.py:29-47``); the port runs where no image
library is installed, so it carries its own codec:

- ``decode_png``: a non-interlaced PNG at bit depth 8 or 16 in colour type
  0 (gray), 2 (RGB), 3 (palette, depth 8), 4 (gray + alpha) or 6 (RGBA),
  with all five row filters and the chunk CRCs checked, to RGB float32 in
  [0, 1]: what ``cv2.imdecode(IMREAD_COLOR)`` followed by the BGR->RGB swap
  and ``/ 255`` gives. Alpha is dropped, gray repeated into three channels,
  a 16-bit sample taken as its high byte (``>> 8``).
- ``encode_png``: 8-bit RGB (colour type 2), every row unfiltered (filter
  0), the IDAT compressed by ``zlib`` at level 1, after the JAX server's
  rounding ``clip(x * 255 + 0.5, 0, 255)``.

Anything else (GIF, BMP, TIFF, WebP, an interlaced PNG, another bit depth)
raises ``ValueError`` naming what it is. ``decode_image_u8`` and
``decode_image`` take a PNG or a JPEG, dispatching on the magic bytes; a JPEG
goes to ``pipeline/jpeg.py``'s baseline decoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tpusr_torch.pipeline.jpeg import MAX_PIXELS, decode_jpeg_u8

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (8, 16), 2: (8, 16), 3: (8,), 4: (8, 16), 6: (8, 16)}
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
          (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
ENCODE_LEVEL = 1


def image_format(body: bytes) -> str | None:
    """The name of the image format ``body`` starts with, or None."""
    if body.startswith(SIGNATURE):
        return "PNG"
    if body[:4] == b"RIFF" and body[8:12] == b"WEBP":
        return "WebP"
    return next((name for magic, name in _MAGIC if body.startswith(magic)),
                None)


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


def decode_png_u8(body: bytes,
                  expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """PNG bytes -> (h, w, 3) uint8 RGB (see the module docstring). With
    ``expected_hw``, an image of another size is refused before its data is
    inflated; the data is inflated only as far as the image needs."""
    fmt = image_format(body)
    if fmt != "PNG":
        raise ValueError(f"a {fmt} image, not a PNG" if fmt else
                         "request body is not a decodable image (PNG expected)")
    header = palette = None
    idat = []
    for ctype, data in _chunks(body):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, color, comp, filt, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported; send a "
                         "non-interlaced PNG")
    if color not in _CHANNELS or comp or filt:
        raise ValueError(f"PNG colour type {color}, compression {comp}, "
                         f"filter method {filt} is not a valid PNG")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"PNG bit depth {depth} in colour type {color} is "
                         f"not supported (8 or 16; palettes 8)")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {height}x{width} is over 2^30 pixels "
                         f"(OpenCV's limit)")
    if expected_hw is not None and (height, width) != tuple(expected_hw):
        raise ValueError(f"expected {expected_hw[0]}x{expected_hw[1]} LR "
                         f"input, got a {height}x{width} PNG")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    need = height * (width * bpp + 1)
    try:
        z = zlib.decompressobj()
        raw = z.decompress(b"".join(idat), need)
        if len(raw) < need and not z.eof:
            raise zlib.error("incomplete or truncated stream")
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    rows = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:      # big-endian samples: the high byte is >> 8
        s = rows.reshape(height, width, ch, 2)[..., 0]
    else:
        s = rows.reshape(height, width, ch)
    if color == 3:
        if int(s.max(initial=0)) >= palette.shape[0]:
            raise ValueError("PNG palette index beyond its PLTE entries")
        return palette[s[..., 0]]
    if color in (0, 4):
        return np.repeat(s[..., :1], 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


def decode_png(body: bytes) -> np.ndarray:
    """PNG bytes -> (h, w, 3) float32 RGB in [0, 1]."""
    return decode_png_u8(body).astype(np.float32) / 255.0


def decode_image_u8(body: bytes,
                    expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """PNG or JPEG bytes -> (h, w, 3) uint8 RGB, what ``cv2.imdecode(
    IMREAD_COLOR)`` and the BGR->RGB swap give; another format raises
    ``ValueError`` naming it. ``expected_hw`` refuses an image whose header
    declares another size before its data is decoded (a JPEG's EXIF
    orientation may still transpose it: check the result's shape too)."""
    fmt = image_format(body)
    if fmt == "PNG":
        return decode_png_u8(body, expected_hw)
    if fmt == "JPEG":
        return decode_jpeg_u8(body, expected_hw)
    raise ValueError(
        f"request body is a {fmt} image; this server decodes PNG and "
        f"baseline JPEG only" if fmt else
        "request body is not a decodable image (PNG or JPEG expected)")


def decode_image(body: bytes,
                 expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """PNG or JPEG bytes -> (h, w, 3) float32 RGB in [0, 1]."""
    return decode_image_u8(body, expected_hw).astype(np.float32) / 255.0


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
