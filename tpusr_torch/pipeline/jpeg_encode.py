"""Baseline JPEG encode in numpy, beside the decoder ``pipeline/jpeg.py``.

The JAX package re-encodes the degraded LR image with
``cv2.imencode(".jpeg", bgr, [IMWRITE_JPEG_QUALITY, q])``, which is
libjpeg-turbo with OpenCV's settings. ``encode_jpeg_u8`` writes the same
bytes:

- SOI, APP0 JFIF 1.01 (no units, density 1:1), one DQT per table, SOF0
  (three components: Y at 2x2, Cb and Cr at 1x1, i.e. 4:2:0), the four
  standard Huffman tables of Annex K (no optimisation), one interleaved
  scan, no restart interval, EOI;
- the tables scaled as ``jpeg_set_quality`` scales them (q < 50: 5000/q,
  else 200 - 2q; ``(std * scale + 50) / 100`` clamped to 1..255);
- RGB -> YCbCr in ``jccolor.c``'s 16-bit fixed point (the chroma offset
  rounds with ONE_HALF - 1);
- the chroma downsampled 2x2 by ``h2v2_downsample`` (bias 1, 2, 1, 2, ...
  along a row), after the right edge is replicated to a whole block and the
  bottom row to an even height; every plane's bottom padded by repeating
  its last row;
- the islow forward DCT (``jfdctint.c``) and the reciprocal quantiser of
  ``jcdctmgr.c`` (``compute_reciprocal``), which is what libjpeg-turbo's
  SIMD code computes;
- the partial MCUs' dummy Y blocks of ``jccoefct.c``: zero AC, the DC of the
  block before them.

Entropy coding runs over all blocks at once: each coded coefficient becomes
one bit string (its zero-run codes, its Huffman code and its extra bits),
and the strings are packed and byte-stuffed with numpy.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

# Annex K's tables in natural (row-major) order
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64)
# the natural index of each zig-zag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3's Huffman tables: (code counts by length 1..16, symbols)
_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
            bytes(range(12)))
_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
              bytes(range(12)))
_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]))
_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]))
# jfdctint.c's constants, FIX(x) at CONST_BITS 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def quant_table(std: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality``'s table (natural order) at ``quality``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((std * scale + 50) // 100, 1, 255)


def _code_table(spec) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of each of the 256 symbols of a DHT spec."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for n_bits in range(1, 17):
        for _ in range(counts[n_bits - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, n_bits
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_DC_CODES = (_code_table(_DC_LUMA), _code_table(_DC_CHROMA))
_AC_CODES = (_code_table(_AC_LUMA), _code_table(_AC_CHROMA))


def _rgb_to_ycc(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``jccolor.c``'s ``rgb_ycc_convert`` (SCALEBITS 16)."""
    def fix(v):
        return int(v * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b
          + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b
          + offset + half - 1) >> 16
    return y, cb, cr


def _pad_edge(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                  mode="edge")


def _downsample_h2v2(p: np.ndarray) -> np.ndarray:
    """``h2v2_downsample`` of an even-sized plane: the 2x2 sums with the
    bias 1, 2, 1, 2, ... along each output row."""
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias[None]) >> 2


def _fdct_1d(d):
    """jfdctint.c's 1-D stage on 8 arrays; returns (even outputs 0 and 4
    unscaled, the other six before their descale) in output order."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * _F0541
    out2 = z1 + tmp13 * _F0765
    out6 = z1 - tmp12 * _F1847
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    return [tmp10 + tmp11, tmp7 + z1 + z4, out2, tmp6 + z2 + z3,
            tmp10 - tmp11, tmp5 + z2 + z4, out6, tmp4 + z1 + z3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(..., 8, 8) level-shifted samples -> (..., 8, 8) coefficients scaled
    by 8, as ``jpeg_fdct_islow`` (row = vertical frequency)."""
    x = blocks.astype(np.int64)
    rows = _fdct_1d([x[..., :, k] for k in range(8)])     # pass 1: rows
    ws = [rows[k] << _PASS1_BITS if k in (0, 4)
          else _descale(rows[k], _CONST_BITS - _PASS1_BITS) for k in range(8)]
    ws = np.stack(ws, axis=-1)
    cols = _fdct_1d([ws[..., k, :] for k in range(8)])    # pass 2: columns
    out = [_descale(cols[k], _PASS1_BITS) if k in (0, 4)
           else _descale(cols[k], _CONST_BITS + _PASS1_BITS) for k in range(8)]
    return np.stack(out, axis=-2)


@functools.lru_cache(maxsize=32)
def _reciprocals(table: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``compute_reciprocal`` of each divisor (the table x 8): reciprocal,
    correction and shift, so that q = ((|x| + c) * f) >> r."""
    fq, corr, shift = (np.zeros(64, np.int64) for _ in range(3))
    for i, qv in enumerate(np.frombuffer(table, np.int64)):
        d = int(qv) << 3
        b = d.bit_length() - 1
        r = 16 + b
        f, rem = divmod(1 << r, d)
        c = d // 2
        if rem == 0:
            f >>= 1
            r -= 1
        elif rem <= d // 2:
            c += 1
        else:
            f += 1
        fq[i], corr[i], shift[i] = f, c, r
    return fq, corr, shift


def _quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    fq, corr, shift = _reciprocals(table.astype(np.int64).tobytes())
    flat = coef.reshape(*coef.shape[:-2], 64)
    q = ((np.abs(flat) + corr) * fq) >> shift
    return np.where(flat < 0, -q, q)


def _blocks(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """A padded plane -> its quantised blocks (rows, cols, 64) in zig-zag
    order."""
    h, w = plane.shape
    b = (plane - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    return _quantize(fdct_islow(b), table)[..., _ZIGZAG]


def _nbits(v: np.ndarray) -> np.ndarray:
    """The JPEG magnitude category of each value (bits of |v|)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while True:
        more = a >> n > 0
        if not more.any():
            return n
        n += more


def _entropy_code(blocks: np.ndarray, table_ids: np.ndarray,
                  comp_ids: np.ndarray) -> bytes:
    """Huffman-code (N, 64) zig-zag blocks in scan order, block i with the
    tables of ``table_ids[i]`` and the DC predictor of ``comp_ids[i]``;
    returns the byte-stuffed scan."""
    n = blocks.shape[0]
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp_ids):
        sel = np.nonzero(comp_ids == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    # items: (block, slot, code bits, length), slot 0 the DC, 1..63 an AC
    # coefficient with its zero runs before it, 64 the EOB
    nb = _nbits(diff)
    dc_code = np.where(table_ids == 0, _DC_CODES[0][0][nb], _DC_CODES[1][0][nb])
    dc_len = np.where(table_ids == 0, _DC_CODES[0][1][nb], _DC_CODES[1][1][nb])
    dc_bits = (dc_code << nb) | ((diff - (diff < 0)) & ((1 << nb) - 1))
    items = [(np.arange(n), np.zeros(n, np.int64), dc_bits, dc_len + nb)]

    ac = blocks[:, 1:]
    bi, k = np.nonzero(ac)
    k = k + 1
    prev = np.zeros_like(k)
    same = np.zeros(len(k), bool)
    same[1:] = bi[1:] == bi[:-1]
    prev[1:] = np.where(same[1:], k[:-1], 0)
    run = k - prev - 1
    zrl, run = run >> 4, run & 15
    val = ac[bi, k - 1]
    nb = _nbits(val)
    sym = (run << 4) | nb
    t = table_ids[bi]
    code = np.where(t == 0, _AC_CODES[0][0][sym], _AC_CODES[1][0][sym])
    clen = np.where(t == 0, _AC_CODES[0][1][sym], _AC_CODES[1][1][sym])
    zcode = np.where(t == 0, _AC_CODES[0][0][0xF0], _AC_CODES[1][0][0xF0])
    zlen = np.where(t == 0, _AC_CODES[0][1][0xF0], _AC_CODES[1][1][0xF0])
    bits = np.zeros(len(k), np.int64)
    length = np.zeros(len(k), np.int64)
    for j in range(3):                       # at most three ZRLs (run <= 62)
        on = zrl > j
        bits = np.where(on, (bits << zlen) | zcode, bits)
        length = np.where(on, length + zlen, length)
    bits = (((bits << clen) | code) << nb) | ((val - (val < 0)) & ((1 << nb) - 1))
    items.append((bi, k, bits, length + clen + nb))

    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    te = table_ids[eob]
    items.append((eob, np.full(len(eob), 64, np.int64),
                  np.where(te == 0, _AC_CODES[0][0][0], _AC_CODES[1][0][0]),
                  np.where(te == 0, _AC_CODES[0][1][0], _AC_CODES[1][1][0])))

    blk, slot, bits, length = (np.concatenate(a) for a in zip(*items))
    order = np.lexsort((slot, blk))
    bits, length = bits[order], length[order]
    return _pack(bits, length)


def _pack(bits: np.ndarray, length: np.ndarray) -> bytes:
    """Concatenate bit strings MSB first, pad with ones to a byte, stuff a
    zero byte after every 0xFF."""
    total = int(length.sum())
    ends = np.cumsum(length)
    owner = np.repeat(np.arange(len(length)), length)
    pos = np.arange(total) - (ends - length)[owner]
    stream = (bits[owner] >> (length[owner] - 1 - pos)) & 1
    pad = -total % 8
    stream = np.concatenate([stream, np.ones(pad, np.int64)]).astype(np.uint8)
    out = np.packbits(stream)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def encode_jpeg_u8(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(h, w, 3) uint8 RGB -> the bytes ``cv2.imencode(".jpeg", bgr,
    [cv2.IMWRITE_JPEG_QUALITY, quality])`` writes for its BGR twin (see the
    module docstring). OpenCV's default quality is 95."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg_u8 takes an (h, w, 3) uint8 image, "
                         f"not {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"JPEG sides are 1..65535, not {h}x{w}")
    tables = (quant_table(_STD_LUMA, quality), quant_table(_STD_CHROMA, quality))
    y, cb, cr = _rgb_to_ycc(rgb)
    mcu_r, mcu_c = -(-h // 16), -(-w // 16)
    yb_r, yb_c = -(-h // 8), -(-w // 8)
    yq = _blocks(_pad_edge(y, yb_r * 8, yb_c * 8), tables[0])
    chroma = []
    for p in (cb, cr):
        p = _downsample_h2v2(_pad_edge(p, -(-h // 2) * 2, mcu_c * 16))
        chroma.append(_blocks(_pad_edge(p, mcu_r * 8, mcu_c * 8), tables[1]))
    # the Y grid of whole MCUs, with jccoefct.c's dummy blocks
    grid = np.zeros((2 * mcu_r, 2 * mcu_c, 64), np.int64)
    grid[:yb_r, :yb_c] = yq
    if yb_c % 2:
        grid[:yb_r, yb_c, 0] = grid[:yb_r, yb_c - 1, 0]
    if yb_r % 2:
        grid[yb_r, :, 0] = np.repeat(grid[yb_r - 1, 1::2, 0], 2)
    ygrid = grid.reshape(mcu_r, 2, mcu_c, 2, 64).transpose(0, 2, 1, 3, 4)
    mcus = np.concatenate([ygrid.reshape(mcu_r, mcu_c, 4, 64),
                           chroma[0][:, :, None], chroma[1][:, :, None]], axis=2)
    blocks = mcus.reshape(-1, 64)
    n_mcu = mcu_r * mcu_c
    comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2]), n_mcu)
    scan = _entropy_code(blocks, np.minimum(comp_ids, 1), comp_ids)

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, t in enumerate(tables):
        out.append(_segment(0xDB, bytes([i]) + t[_ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc_th, spec in ((0x00, _DC_LUMA), (0x10, _AC_LUMA),
                        (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)):
        out.append(_segment(0xC4, bytes([tc_th]) + spec[0] + spec[1]))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)
