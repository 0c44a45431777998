"""FFmpeg's 8-bit ``simple_idct``, the inverse DCT that its MJPEG and
MPEG-4 Part 2 decoders use on x86 (``ff_simple_idct8_put_sse2`` and
``_add_sse2``, equal to the C ``ff_simple_idct_put_int16_8bit`` and
``_add``): rows then columns in 32-bit fixed point, each row's result
truncated to int16, a row whose AC coefficients are all zero taking the
``DC << 3`` shortcut.

- ``simple_idct``: the ``put`` form, the columns' results clamped to
  0..255 (an intra block);
- ``simple_idct_add``: the ``add`` form, the columns' results added to the
  prediction, then clamped (an inter block's residual).
"""

from __future__ import annotations

import numpy as np

# simple_idct's 8-bit weights, round(cos(k pi / 16) sqrt(2) 2^14)
_W1, _W2, _W3, _W4, _W5, _W6, _W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


def wrap_int16(x: np.ndarray) -> np.ndarray:
    """``x`` cast to int16 as C casts it (wrapping), kept as int64."""
    return ((x + 32768) & 0xFFFF) - 32768


def _i32(x: np.ndarray) -> np.ndarray:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _columns(block: np.ndarray) -> np.ndarray:
    """(..., 8, 8) coefficients (row = vertical frequency) -> (..., 8, 8)
    int64 outputs of the column pass, before clamping."""
    b = block.astype(np.int64)
    r = [b[..., :, k] for k in range(8)]
    a0 = _W4 * r[0] + (1 << 10) + _W2 * r[2] + _W4 * r[4] + _W6 * r[6]
    a1 = _W4 * r[0] + (1 << 10) + _W6 * r[2] - _W4 * r[4] - _W2 * r[6]
    a2 = _W4 * r[0] + (1 << 10) - _W6 * r[2] - _W4 * r[4] + _W2 * r[6]
    a3 = _W4 * r[0] + (1 << 10) - _W2 * r[2] + _W4 * r[4] - _W6 * r[6]
    b0 = _W1 * r[1] + _W3 * r[3] + _W5 * r[5] + _W7 * r[7]
    b1 = _W3 * r[1] - _W7 * r[3] - _W1 * r[5] - _W5 * r[7]
    b2 = _W5 * r[1] - _W1 * r[3] + _W7 * r[5] + _W3 * r[7]
    b3 = _W7 * r[1] - _W5 * r[3] + _W3 * r[5] - _W1 * r[7]
    rows = np.stack([wrap_int16(_i32(x) >> 11) for x in
                     (a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                      a3 - b3, a2 - b2, a1 - b1, a0 - b0)], axis=-1)
    dc_only = ~np.any(b[..., :, 1:], axis=-1)           # idctRowCondDC
    rows = np.where(dc_only[..., None], wrap_int16(r[0] * 8)[..., None],
                    rows)
    c = [rows[..., k, :] for k in range(8)]
    a0 = _W4 * (c[0] + 32) + _W2 * c[2] + _W4 * c[4] + _W6 * c[6]
    a1 = _W4 * (c[0] + 32) + _W6 * c[2] - _W4 * c[4] - _W2 * c[6]
    a2 = _W4 * (c[0] + 32) - _W6 * c[2] - _W4 * c[4] + _W2 * c[6]
    a3 = _W4 * (c[0] + 32) - _W2 * c[2] + _W4 * c[4] - _W6 * c[6]
    b0 = _W1 * c[1] + _W3 * c[3] + _W5 * c[5] + _W7 * c[7]
    b1 = _W3 * c[1] - _W7 * c[3] - _W1 * c[5] - _W5 * c[7]
    b2 = _W5 * c[1] - _W1 * c[3] + _W7 * c[5] + _W3 * c[7]
    b3 = _W7 * c[1] - _W5 * c[3] + _W3 * c[5] - _W1 * c[7]
    return np.stack([_i32(x) >> 20 for x in
                     (a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                      a3 - b3, a2 - b2, a1 - b1, a0 - b0)], axis=-2)


def simple_idct(block: np.ndarray) -> np.ndarray:
    """The ``put`` form: (..., 8, 8) dequantised coefficients -> (..., 8,
    8) uint8."""
    return np.clip(_columns(block), 0, 255).astype(np.uint8)


def simple_idct_add(block: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """The ``add`` form: (..., 8, 8) coefficients and the (..., 8, 8)
    uint8 prediction -> the reconstructed uint8 block."""
    return np.clip(pred.astype(np.int64) + _columns(block), 0,
                   255).astype(np.uint8)
