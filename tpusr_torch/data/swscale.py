"""swscale's unscaled ``yuv420p``/``yuv422p`` -> ``bgr24`` converter, as its
SSSE3 code computes it on x86 (what ``cv2.VideoCapture`` hands back after
FFmpeg decodes a frame).

``ff_yuv2rgb_c_init_tables`` derives the coefficients from the BT.601
matrix (swscale's default colourspace; contrast and saturation 1, no
brightness), by the input's range:

- full range (``yuvj420p``, what MJPEG decodes to): the chroma
  coefficients scaled by 224/255, no luma offset;
- limited range (``yuv420p``, what MPEG-4 Part 2 decodes to): the luma
  scaled by 255/219 with an offset of 16, the chroma coefficients as they
  are (the table already holds the 255/224 of the limited chroma swing).

Each is rounded to int16 in the converter's fixed point (``roundToInt16``
of the 16.16 value times 2^13); the kernel scales each plane by 8,
subtracts the offsets (``16 * 8`` for limited luma, ``128 * 8`` for
chroma), multiplies with ``pmulhw`` (the high half of the 32-bit product),
adds with saturation and packs to 0..255. The chroma sample covers its 2x2
(4:2:0) or 2x1 (4:2:2) pixels.
"""

from __future__ import annotations

import numpy as np

# ff_yuv2rgb_coeffs[SWS_CS_DEFAULT]: v->r, u->b, u->g, v->g in 16.16
_BT601 = (104597, 132201, 25675, 53279)


def _round_int16(f: int) -> int:
    """swscale's ``roundToInt16``."""
    return max(-0x7FFF, min(0x7FFF, (f + (1 << 15)) >> 16))


def yuv2rgb_coefficients(full_range: bool) -> tuple[int, ...]:
    """(y, v->r, u->b, u->g, v->g, y offset) of the SSSE3 converter, as
    ``ff_yuv2rgb_c_init_tables`` sets them for BT.601 input."""
    crv, cbu, cgu, cgv = _BT601
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu = crv * 224 // 255, cbu * 224 // 255
        cgu, cgv = cgu * 224 // 255, cgv * 224 // 255
    else:
        cy, oy = cy * 255 // 219, 16 << 16
    return tuple(_round_int16(v << 13) for v in (cy, crv, cbu, cgu, cgv)) + (
        _round_int16(oy << 3),)


_TABLES = {r: yuv2rgb_coefficients(r) for r in (True, False)}


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray, rows: int,
               full_range: bool) -> np.ndarray:
    """Planes of uint8 samples at their own resolution, the chroma planes
    subsampled by 2 across and by ``rows`` (2 or 1) down, -> (h, w, 3)
    uint8 BGR of the luma plane's size."""
    cy, cvr, cub, cug, cvg, oy = _TABLES[full_range]
    h, w = y.shape

    def up(p):
        return np.repeat(np.repeat(p.astype(np.int64), rows, axis=0), 2,
                         axis=1)[:h, :w]

    yy = ((y.astype(np.int64) * 8 - oy) * cy) >> 16
    uu, vv = up(u) * 8 - 1024, up(v) * 8 - 1024
    b = yy + ((uu * cub) >> 16)
    g = yy + (((uu * cug) >> 16) + ((vv * cvg) >> 16))
    r = yy + ((vv * cvr) >> 16)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)
