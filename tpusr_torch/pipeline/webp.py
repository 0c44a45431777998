"""WebP in numpy: what ``cv2.imdecode(IMREAD_COLOR)`` gives through
libwebp (``WebPDecodeBGRInto``, or ``WebPAnimDecoder`` for an animation),
swapped to RGB.

- The RIFF container: a simple file (one ``VP8 `` or ``VP8L`` chunk) or an
  extended one (``VP8X``, then chunks up to the image: ``ALPH`` kept,
  ``ICCP``, ``EXIF``, ``XMP `` and any other skipped, as libwebp does;
  the canvas must be the image's size). The RIFF size may not run past the
  body; bytes after it are ignored. OpenCV reads no file under 32 bytes.
- Lossy images (``vp8.py``) to RGB as libwebp does by default: the 4:2:0
  chroma upsampled by the "fancy" 9-3-3-1 filter on each pair of rows
  (``UpsampleRgbLinePair``), the first and, at an even height, the last row
  from one chroma row; each pixel by ``yuv.h``'s fixed point (``MultHi``,
  ``YUV_FIX2`` 6).
- Lossless images (``vp8l.py``): the ARGB's colour bytes.
- Alpha: an ``ALPH`` chunk (raw, or a headerless VP8L stream, with its
  filter) is decoded and must be valid, as libwebp requires, and is
  dropped: under ``IMREAD_COLOR`` OpenCV keeps the colour bytes of the
  unpremultiplied BGRA.
- An animation (``ANIM``/``ANMF``): the first frame as ``WebPAnimDecoder``
  composes it, its colour pasted at its offset on a black canvas (the first
  frame is a key frame: no blending, no background colour).

What libwebp or OpenCV refuses raises ``ValueError``; the sizes a header
declares are checked against the body before anything is allocated.
"""

from __future__ import annotations

import struct

import numpy as np

from tpusr_torch.pipeline import vp8, vp8l

MIN_BODY = 32                   # OpenCV's WEBP_HEADER_SIZE
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30   # OpenCV's CV_IO_MAX_IMAGE_*


def _chunks(body: bytes, pos: int, end: int):
    """(tag, payload start, payload size) of each chunk from ``pos``; a
    chunk that runs past ``end`` ends the walk with a ``ValueError``
    unless it is the image's (libwebp reads that one on to the end)."""
    while pos + 8 <= end:
        tag = body[pos:pos + 4]
        size = struct.unpack("<I", body[pos + 4:pos + 8])[0]
        yield tag, pos + 8, size
        pos += 8 + size + (size & 1)
    if pos < end:
        raise ValueError("WebP chunk header truncated")


def _vp8x(body: bytes, start: int, size: int):
    if size != 10:
        raise ValueError(f"WebP VP8X chunk of {size} bytes, not 10")
    flags = body[start]
    w = 1 + int.from_bytes(body[start + 4:start + 7], "little")
    h = 1 + int.from_bytes(body[start + 7:start + 10], "little")
    if w > MAX_SIDE or h > MAX_SIDE or w * h > MAX_PIXELS:
        raise ValueError(f"WebP canvas {w}x{h} is too large")
    return flags, w, h


def _check_hw(hw, expected_hw):
    if expected_hw is not None and tuple(hw) != tuple(expected_hw):
        raise ValueError(f"image is {hw[0]}x{hw[1]}, expected "
                         f"{expected_hw[0]}x{expected_hw[1]}")


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fancy upsampling and YUV->RGB of (h, w) Y and
    ((h+1)//2, (w+1)//2) U, V planes -> (h, w, 3) uint8."""
    h, w = y.shape
    uvh = u.shape[0]
    r = np.arange(h)
    k = (r + 1) // 2
    odd = (r % 2) == 1
    near = np.where(odd, k - 1, k)                 # the nearer chroma row
    far = np.where(odd, np.minimum(k, uvh - 1), k - 1)
    near[0] = far[0] = 0
    out = []
    for plane in (u, v):
        p = plane.astype(np.int32)
        a, b = p[near], p[far]
        full = np.empty((h, w), np.int32)
        full[:, 0] = (3 * a[:, 0] + b[:, 0] + 2) >> 2
        n = (w - 1) >> 1
        if n:
            a0, a1 = a[:, :n], a[:, 1:n + 1]
            b0, b1 = b[:, :n], b[:, 1:n + 1]
            d1 = (a0 + 3 * a1 + 3 * b0 + b1 + 8) >> 3
            d2 = (3 * a0 + a1 + b0 + 3 * b1 + 8) >> 3
            full[:, 1:2 * n:2] = (d1 + a0) >> 1
            full[:, 2:2 * n + 1:2] = (d2 + a1) >> 1
        if w % 2 == 0:
            full[:, w - 1] = (3 * a[:, -1] + b[:, -1] + 2) >> 2
        out.append(full)
    uu, vv = out
    yy = (y.astype(np.int32) * 19077) >> 8

    def clip8(x):
        return np.clip(x >> 6, 0, 255)

    rgb = np.stack([
        clip8(yy + ((vv * 26149) >> 8) - 14234),
        clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708),
        clip8(yy + ((uu * 33050) >> 8) - 17685)], -1)
    return rgb.astype(np.uint8)


def _alpha(body: bytes, start: int, size: int, w: int, h: int) -> np.ndarray:
    """The ``ALPH`` chunk's (h, w) alpha plane (ALPHInit + unfiltering)."""
    if size <= 1:
        raise ValueError("WebP ALPH chunk without data")
    hdr = body[start]
    method, filt, pre = hdr & 3, (hdr >> 2) & 3, (hdr >> 4) & 3
    if method > 1 or pre > 1 or hdr >> 6:
        raise ValueError(f"WebP ALPH header {hdr:#04x} is not valid")
    data = body[start + 1:start + size]
    if method == 0:
        if len(data) < w * h:
            raise ValueError("WebP ALPH plane truncated")
        a = np.frombuffer(data, np.uint8, w * h).reshape(h, w)
    else:
        a = ((vp8l.decode_stream(data, w, h) >> 8) & 0xFF).astype(np.uint8)
    return _unfilter(a, filt)


def _unfilter(a: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's Horizontal/Vertical/GradientUnfilter_C, mod 256."""
    if filt == 0:
        return a
    x = a.astype(np.int64)
    out = np.empty_like(x)
    out[0] = np.cumsum(x[0]) & 0xFF
    if filt == 1:                     # left, the first column from above
        first = np.cumsum(x[:, 0]) & 0xFF
        out[1:] = (np.cumsum(x[1:], 1) - x[1:, :1] + first[1:, None]) & 0xFF
    elif filt == 2:                   # from above
        out[1:] = (np.cumsum(x[1:], 0) + out[0]) & 0xFF
    else:                             # gradient
        for r in range(1, a.shape[0]):
            prev = out[r - 1].tolist()
            row = x[r].tolist()
            left = top_left = prev[0]
            new = []
            for i, d in enumerate(row):
                top = prev[i]
                g = min(max(left + top - top_left, 0), 255)
                left = (d + g) & 0xFF
                top_left = top
                new.append(left)
            out[r] = new
    return out.astype(np.uint8)


def _image(body: bytes, tag: bytes, start: int, size: int, alph,
           canvas=None, tools=None):
    """(rgb, alpha or None) of a ``VP8 ``/``VP8L`` chunk at ``start``."""
    if tools is not None:
        tools["codec"] = "lossless" if tag == b"VP8L" else "lossy"
        if alph is not None:
            hdr = body[alph[0]]
            tools["alpha"] = {"method": hdr & 3, "filter": (hdr >> 2) & 3}
    if tag == b"VP8L":
        w, h = vp8l.image_size(body[start:start + size])
        if canvas is not None and canvas != (w, h):
            raise ValueError("WebP canvas differs from its image's size")
        argb = vp8l.decode_image(body[start:], tools)
        rgb = np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF,
                        argb & 0xFF], -1).astype(np.uint8)
        return rgb, (argb >> 24).astype(np.uint8)
    w, h = vp8.frame_size(body, start, size)
    if canvas is not None and canvas != (w, h):
        raise ValueError("WebP canvas differs from its image's size")
    frame = vp8.decode_frame(body, start, size)
    if tools is not None:
        tools.update(frame.tools)
    alpha = _alpha(body, *alph, w, h) if alph is not None else None
    return yuv_to_rgb(frame.y, frame.u, frame.v), alpha


def decode_webp(body: bytes, expected_hw: tuple[int, int] | None = None,
                tools: dict | None = None):
    """WebP bytes -> ((h, w, 3) uint8 RGB, (h, w) uint8 alpha or None);
    ``tools``, when given, gets what the bitstream used."""
    if len(body) < MIN_BODY:
        raise ValueError(f"WebP body of {len(body)} bytes: OpenCV reads "
                         f"none under {MIN_BODY}")
    if body[:4] != b"RIFF" or body[8:12] != b"WEBP":
        raise ValueError("not a WebP image (no RIFF/WEBP header)")
    riff = struct.unpack("<I", body[4:8])[0]
    if riff < 12 or riff > len(body) - 8:
        raise ValueError(f"WebP RIFF size {riff} does not fit the body")
    end = 8 + riff
    tag = body[12:16]
    first_size = struct.unpack("<I", body[16:20])[0]
    if tag in (b"VP8 ", b"VP8L"):
        _check_image_chunk(body, 20, first_size, riff)
        w, h = vp8l.image_size(body[20:20 + first_size]) if tag == b"VP8L" \
            else vp8.frame_size(body, 20, first_size)
        _check_hw((h, w), expected_hw)
        return _image(body, tag, 20, first_size, None, tools=tools)
    if tag != b"VP8X":
        raise ValueError(f"WebP first chunk {tag!r} is not VP8, VP8L or "
                         f"VP8X")
    flags, cw, ch = _vp8x(body, 20, first_size)
    _check_hw((ch, cw), expected_hw)
    alph = None
    pos = 30
    if flags & 0x02:                                  # animation
        if tools is not None:
            tools["animation"] = True
        return _first_frame(body, pos, end, cw, ch, flags, tools)
    total = 22                    # ParseOptionalChunks: "WEBP" + VP8X
    for tag, start, size in _chunks(body, pos, len(body)):
        total += (8 + size + 1) & ~1
        if total > riff:
            raise ValueError(f"WebP {tag!r} chunk past the RIFF size")
        if tag in (b"VP8 ", b"VP8L"):
            _check_image_chunk(body, start, size, riff)
            return _image(body, tag, start, size, alph, (cw, ch), tools)
        if start + size > len(body):
            raise ValueError(f"WebP {tag!r} chunk truncated")
        if tag == b"ALPH":
            alph = (start, size)
    raise ValueError("WebP file without an image chunk")


def _check_image_chunk(body: bytes, start: int, size: int, riff: int):
    """ParseVP8Header's two size checks of a ``VP8 ``/``VP8L`` chunk."""
    if size > riff - 12:
        raise ValueError(f"WebP image chunk of {size} bytes past its RIFF "
                         f"size {riff}")
    if size > len(body) - start:
        raise ValueError(f"WebP image chunk of {size} bytes truncated")


def _store_frame(body: bytes, pos: int, end: int):
    """WebPDemux's StoreFrame from ``pos``: at most one ``ALPH`` and one
    image chunk, in that order, stopping (before it) at any other chunk
    -> (position, alpha (start, size) or None, image (tag, start, size)
    or None). ``end`` is the RIFF's end."""
    alph = image = None
    while end - pos >= 8:
        tag = body[pos:pos + 4]
        n = struct.unpack("<I", body[pos + 4:pos + 8])[0]
        padded = n + (n & 1)
        if padded > end - pos - 8:
            raise ValueError(f"WebP {tag!r} chunk past the RIFF size")
        if tag == b"ALPH" and alph is None and image is None:
            alph = (pos + 8, n)
        elif tag in (b"VP8 ", b"VP8L") and image is None:
            if tag == b"VP8L" and alph is not None:
                raise ValueError("WebP frame of VP8L after ALPH")
            # WebPGetFeatures on the chunk alone
            if tag == b"VP8L":
                vp8l.image_size(body[pos + 8:pos + 8 + n])
            else:
                vp8.frame_size(body, pos + 8, n)
            image = (tag, pos + 8, n)
        else:
            break
        pos += 8 + padded
    else:
        if pos != end:
            raise ValueError("WebP chunk header truncated")
    return pos, alph, image


def _first_frame(body: bytes, pos: int, end: int, cw: int, ch: int,
                 flags: int, tools=None):
    """The first frame as WebPAnimDecoder composes it, on a black canvas
    at its offset, after the file passes WebPDemux's parse: valid flags;
    ``ANIM`` before the frames; each ``ANMF`` a 16-byte header, then
    StoreFrame's chunks, parsing going on at the top level from where
    StoreFrame stopped (a frame with neither alpha nor image is dropped;
    an image chunk at the top level is an error); every frame with an
    image, within the canvas at its bitstream's size."""
    if flags & ~0x3E:
        raise ValueError(f"WebP VP8X flags {flags:#04x} set reserved bits")
    anim, frames = False, []
    while pos != end:
        if end - pos < 8:
            raise ValueError("WebP chunk header truncated")
        tag = body[pos:pos + 4]
        n = struct.unpack("<I", body[pos + 4:pos + 8])[0]
        padded = n + (n & 1)
        if padded > end - pos - 8:
            raise ValueError(f"WebP {tag!r} chunk past the RIFF size")
        if tag in (b"VP8X", b"ALPH", b"VP8 ", b"VP8L"):
            raise ValueError(f"WebP {tag!r} chunk outside a frame of an "
                             f"animation")
        if tag == b"ANIM" and padded < 6:
            raise ValueError("WebP ANIM chunk shorter than 6 bytes")
        if tag != b"ANMF":
            anim |= tag == b"ANIM"
            pos += 8 + padded
            continue
        if not anim:
            raise ValueError("WebP ANMF chunk before its ANIM chunk")
        if padded < 16:
            raise ValueError("WebP ANMF chunk shorter than its header")
        f = body[pos + 8:pos + 24]
        if (1 + int.from_bytes(f[6:9], "little")) \
                * (1 + int.from_bytes(f[9:12], "little")) >= 1 << 32:
            raise ValueError("WebP frame too large")
        start = pos + 24
        pos, alph, image = _store_frame(body, start, end)
        if pos - start > padded - 16:
            raise ValueError("WebP frame's chunks past its ANMF chunk")
        if image is None and alph is not None:
            raise ValueError("WebP animation frame with alpha and no image")
        if image is not None:
            tag, s0, n0 = image
            w, h = vp8l.image_size(body[s0:s0 + n0]) if tag == b"VP8L" \
                else vp8.frame_size(body, s0, n0)
            x0 = 2 * int.from_bytes(f[0:3], "little")
            y0 = 2 * int.from_bytes(f[3:6], "little")
            if x0 + w > cw or y0 + h > ch:
                raise ValueError("WebP frame outside its canvas")
            frames.append((x0, y0, w, h, alph, image))
    if not frames:
        raise ValueError("WebP animation without frames")
    x0, y0, w, h, alph, (tag, start, size) = frames[0]
    rgb, alpha = _image(body[:start + size], tag, start, size, alph, None,
                        tools)
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = rgb
    a = np.zeros((ch, cw), np.uint8)
    a[y0:y0 + h, x0:x0 + w] = 255 if alpha is None else alpha
    return canvas, a


def decode_webp_u8(body: bytes,
                   expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """WebP bytes -> (h, w, 3) uint8 RGB, ``cv2.imdecode(IMREAD_COLOR)``'s
    bytes swapped to RGB."""
    return decode_webp(body, expected_hw)[0]
