"""VP8 key frames (RFC 6386) in numpy: the lossy bitstream of a WebP file,
decoded as libwebp's decoder (``src/dec``) decodes it, to the Y, U and V
planes that ``webp.py`` turns into RGB.

- The boolean decoder, read lazily a byte at a time; a read past the end
  of a partition shifts in zeros and marks it, and a partition so marked
  at the end of a macroblock row (modes) or macroblock (tokens) is an
  error, as in libwebp.
- The frame header: segmentation (map and quantiser/filter values,
  absolute or delta), simple and normal loop filter, sharpness, the
  reference and mode deltas, 1-8 token partitions, the quantiser deltas
  (Y2 AC at 155/100 with its minimum 8, UV DC capped at index 117), the
  coefficient probability updates and the skip probability.
- Per macroblock: segment, skip, the 16x16 modes or the ten 4x4 modes of
  ``B_PRED`` (contexts from the blocks above and to the left), the chroma
  mode; tokens in one Python pass with libwebp's contexts, dequantised into
  int16 as libwebp stores them.
- Reconstruction: the Y2 inverse WHT and the exact inverse DCT (20091/35468
  multipliers) for every block at once; prediction macroblock by
  macroblock from the unfiltered frame, with libwebp's edges (127 above the
  frame, 129 left of it, the above-right of the last column repeated);
  then the loop filter in macroblock raster order on the whole frame:
  left edge, inner vertical edges, top edge, inner horizontal edges, at the
  level of the macroblock's segment and mode, inner edges only where the
  block is ``B_PRED`` or has coefficients.

Interframes do not occur in WebP and are refused by name here (the video
decoder ``data/vp8video.py`` decodes them with this module's boolean
decoder, token reader, transforms, intra predictors and loop filter); so is
what libwebp refuses (bad start code, an invisible frame, a profile above
3, truncated partitions), with ``ValueError``. Dequantised coefficients past
16,384, which no encoder writes, are decoded as the C transforms compute
them; libwebp's SSE2 transforms wrap at 16 bits there.
"""

from __future__ import annotations

import numpy as np

from tpusr_torch.pipeline.vp8_tables import (AC_Q, COEF_PROBS,
                                             COEF_UPDATE_PROBS, DC_Q,
                                             KF_BMODE_PROBS)

# libwebp's mode numbers: the 16x16 and chroma modes are DC, TM, VE, HE
DC, TM, VE, HE, RD, VR, LD, VL, HD, HU = range(10)
MODE_NAMES = ("DC", "TM", "VE", "HE", "RD", "VR", "LD", "VL", "HD", "HU")
_BMODE_TREE = (-DC, 1, -TM, 2, -VE, 3, 4, 6, -HE, 5, -RD, -VR, -LD, 7, -VL,
               8, -HD, -HU)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
              (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_NORM = tuple(8 - r.bit_length() if r < 128 else 0 for r in range(256))


class BoolDecoder:
    """RFC 6386's boolean entropy decoder over ``data[start:end]``."""

    __slots__ = ("data", "pos", "end", "value", "rng", "bits", "eof")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.rng, self.bits, self.eof = 0, 255, -8, False

    def bit(self, prob: int) -> int:
        bits = self.bits
        if bits < 0:
            if self.pos < self.end:
                self.value = (self.value << 8) | self.data[self.pos]
                self.pos += 1
            else:
                self.value <<= 8
                self.eof = True
            bits += 8
        rng = self.rng
        split = 1 + (((rng - 1) * prob) >> 8)
        big = split << bits
        if self.value >= big:
            self.value -= big
            rng -= split
            b = 1
        else:
            rng = split
            b = 0
        if rng < 128:
            s = _NORM[rng]
            rng <<= s
            bits -= s
        self.rng, self.bits = rng, bits
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def _large(self, p) -> int:
        """GetLargeValue: a token of 2 or more."""
        bit = self.bit
        if not bit(p[3]):
            return 2 if not bit(p[4]) else 3 + bit(p[5])
        if not bit(p[6]):
            if not bit(p[7]):
                return 5 + bit(159)
            v = 7 + 2 * bit(165)
            return v + bit(145)
        b1 = bit(p[8])
        cat = 2 * b1 + bit(p[9 + b1])
        v = 0
        for q in _CAT_PROBS[cat]:
            v = v + v + bit(q)
        return v + 3 + (8 << cat)

    def coeffs(self, prob, ctx: int, n: int, dq0: int, dq1: int, out: list,
               base: int) -> int:
        """libwebp's GetCoeffs: one block's tokens from position ``n``,
        dequantised into ``out[base + raster index]``; returns the position
        after the last token read (libwebp's ``nz``)."""
        bit = self.bit
        p = prob[n][ctx]
        while n < 16:
            if not bit(p[0]):
                return n
            while not bit(p[1]):
                n += 1
                if n == 16:
                    return 16
                p = prob[n][0]
            if not bit(p[2]):
                v, nxt = 1, 1
            else:
                v, nxt = self._large(p), 2
            if bit(128):
                v = -v
            out[base + _ZIGZAG[n]] = v * (dq1 if n else dq0)
            n += 1
            p = prob[n][nxt]
        return 16


class Frame:
    """A decoded key frame: ``y`` (height, width), ``u`` and ``v``
    ((height + 1) // 2, (width + 1) // 2), uint8, and what the bitstream
    used (``tools``: mode, filter, segment and partition counts)."""

    def __init__(self, y, u, v, tools):
        self.y, self.u, self.v, self.tools = y, u, v, tools


def frame_size(data: bytes, start: int, size: int) -> tuple[int, int]:
    """(width, height) of the key frame in ``data[start:start + size]``,
    with libwebp's ``VP8GetInfo`` checks."""
    if size < 10 or len(data) < start + 10:
        raise ValueError("VP8 frame shorter than its 10-byte header")
    bits = data[start] | data[start + 1] << 8 | data[start + 2] << 16
    if bits & 1:
        raise ValueError("VP8 interframe: a WebP holds key frames only")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"VP8 profile {(bits >> 1) & 7} is not 0-3")
    if not (bits >> 4) & 1:
        raise ValueError("VP8 frame is not displayable")
    if bits >> 5 >= size:
        raise ValueError("VP8 first partition larger than its chunk")
    if data[start + 3:start + 6] != b"\x9d\x01\x2a":
        raise ValueError("VP8 key frame without its start code")
    w = (data[start + 6] | data[start + 7] << 8) & 0x3FFF
    h = (data[start + 8] | data[start + 9] << 8) & 0x3FFF
    if not w or not h:
        raise ValueError("VP8 frame of zero width or height")
    return w, h


def _clip(v):
    return np.clip(v, 0, 255)


class _Header:
    """The frame header of RFC 6386 section 9, read from partition 0."""

    def __init__(self, br: BoolDecoder):
        br.bit(128)                           # colour space
        br.bit(128)                           # clamping type
        self.segments = br.bit(128)
        self.update_map = 0
        self.absolute = 1                     # libwebp's reset state
        self.seg_q = [0] * 4
        self.seg_lf = [0] * 4
        self.seg_probs = [255] * 3
        if self.segments:
            self.update_map = br.bit(128)
            if br.bit(128):                   # update segment data
                self.absolute = br.bit(128)
                self.seg_q = [br.signed(7) if br.bit(128) else 0
                              for _ in range(4)]
                self.seg_lf = [br.signed(6) if br.bit(128) else 0
                               for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.literal(8) if br.bit(128) else 255
                                  for _ in range(3)]
        if br.eof:
            raise ValueError("VP8 segment header truncated")
        self.simple = br.bit(128)
        self.level = br.literal(6)
        self.sharpness = br.literal(3)
        self.ref_delta = [0] * 4
        self.mode_delta = [0] * 4
        self.use_lf_delta = br.bit(128)
        if self.use_lf_delta and br.bit(128):
            self.ref_delta = [br.signed(6) if br.bit(128) else 0
                              for _ in range(4)]
            self.mode_delta = [br.signed(6) if br.bit(128) else 0
                               for _ in range(4)]
        if br.eof:
            raise ValueError("VP8 filter header truncated")
        self.filter_type = 0 if self.level == 0 else 1 if self.simple else 2
        self.partitions = 1 << br.literal(2)

    def read_quant(self, br: BoolDecoder) -> list[tuple]:
        """VP8ParseQuant: per segment (y1 dc, y1 ac, y2 dc, y2 ac, uv dc,
        uv ac)."""
        base = br.literal(7)
        d = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
        out = []
        for s in range(4):
            if self.segments:
                q = self.seg_q[s] + (0 if self.absolute else base)
            else:
                q = base
            y2ac = AC_Q[min(max(q + d[2], 0), 127)] * 101581 >> 16
            out.append((DC_Q[min(max(q + d[0], 0), 127)],
                        AC_Q[min(max(q, 0), 127)],
                        DC_Q[min(max(q + d[1], 0), 127)] * 2,
                        max(y2ac, 8),
                        DC_Q[min(max(q + d[3], 0), 117)],
                        AC_Q[min(max(q + d[4], 0), 127)]))
        return out

    def filter_strengths(self) -> list[list[tuple]]:
        """PrecomputeFilterStrengths: [segment][is 4x4] -> (limit,
        interior limit, hev threshold), limit 0 for none."""
        out = []
        for s in range(4):
            base = self.level
            if self.segments:
                base = self.seg_lf[s] + (0 if self.absolute else self.level)
            row = []
            for i4 in (0, 1):
                level = base
                if self.use_lf_delta:
                    level += self.ref_delta[0]
                    if i4:
                        level += self.mode_delta[0]
                level = min(max(level, 0), 63)
                if level == 0:
                    row.append((0, 0, 0))
                    continue
                ilevel = level
                if self.sharpness > 0:
                    ilevel >>= 2 if self.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - self.sharpness)
                ilevel = max(ilevel, 1)
                hev = 2 if level >= 40 else 1 if level >= 15 else 0
                row.append((2 * level + ilevel, ilevel, hev))
            out.append(row)
        return out


def _read_probs(br: BoolDecoder):
    """The coefficient probabilities after the frame's updates, as
    [type][position 0-16][context] -> 11 probabilities."""
    probs = bytearray(COEF_PROBS)
    _update_probs(br, probs)
    return _prob_table(probs)


def _update_probs(br: BoolDecoder, probs: bytearray) -> int:
    """The frame's coefficient probability updates, applied to the flat
    ``probs`` in place; returns how many were updated."""
    n = 0
    for i in range(len(probs)):
        if br.bit(COEF_UPDATE_PROBS[i]):
            probs[i] = br.literal(8)
            n += 1
    return n


def _prob_table(probs) -> list:
    """The flat coefficient probabilities as [type][position 0-16][context]
    -> 11 probabilities."""
    table = []
    for t in range(4):
        bands = [[tuple(probs[((t * 8 + b) * 3 + c) * 11:
                              ((t * 8 + b) * 3 + c + 1) * 11])
                  for c in range(3)] for b in range(8)]
        table.append([bands[_BANDS[n]] for n in range(17)])
    return table


def _read_modes(br, hdr, mbw, mbh, skip_prob):
    """Segment, skip, 16x16 or 4x4 modes and chroma mode of every
    macroblock (ParseIntraMode), in raster order."""
    n = mbw * mbh
    seg = [0] * n
    skip = [0] * n
    ymode = [0] * n                    # 16x16 mode, or -1 for B_PRED
    bmodes = [None] * n
    uvmode = [0] * n
    top = [DC] * (4 * mbw)
    bit = br.bit
    sp = hdr.seg_probs
    for mby in range(mbh):
        left = [DC] * 4
        for mbx in range(mbw):
            i = mby * mbw + mbx
            if hdr.update_map:
                seg[i] = bit(sp[1]) if not bit(sp[0]) else 2 + bit(sp[2])
            if skip_prob is not None:
                skip[i] = bit(skip_prob)
            t = top[4 * mbx:4 * mbx + 4]
            if bit(145):
                m = (TM if bit(128) else HE) if bit(156) else \
                    (VE if bit(163) else DC)
                ymode[i] = m
                t = [m] * 4
                left = [m] * 4
            else:
                ymode[i] = -1
                modes = []
                for y in range(4):
                    m = left[y]
                    for x in range(4):
                        prob = KF_BMODE_PROBS[(t[x] * 10 + m) * 9:
                                              (t[x] * 10 + m + 1) * 9]
                        j = _BMODE_TREE[bit(prob[0])]
                        while j > 0:
                            j = _BMODE_TREE[2 * j + bit(prob[j])]
                        m = -j
                        t[x] = m
                    modes.extend(t)
                    left[y] = m
                bmodes[i] = modes
            top[4 * mbx:4 * mbx + 4] = t
            uvmode[i] = DC if not bit(142) else VE if not bit(114) else \
                TM if bit(183) else HE
        if br.eof:
            raise ValueError("VP8 first partition ends before its modes")
    return seg, skip, ymode, bmodes, uvmode


def _read_tokens(parts, mbw, mbh, probs, quant, seg, skip, ymode):
    """Every macroblock's coefficients (ParseResiduals): (mbh, mbw, 25, 16)
    int64, blocks Y 0-15, U 16-19, V 20-23, Y2 24, each in raster order,
    and each block's ``nz`` (mbh, mbw, 25). A macroblock whose ``ymode`` is
    negative has no Y2 block (``B_PRED``; in an interframe also
    ``SPLITMV``)."""
    coefs = []
    nzs = []
    tnz_y, tnz_u, tnz_v = [0] * (4 * mbw), [0] * (2 * mbw), [0] * (2 * mbw)
    tnz_dc = [0] * mbw
    p_i16, p_y2, p_uv, p_i4 = probs
    zero_nz = [0] * 25
    for mby in range(mbh):
        br = parts[mby % len(parts)]
        coeffs = br.coeffs
        lnz_y, lnz_u, lnz_v, lnz_dc = [0] * 4, [0] * 2, [0] * 2, 0
        for mbx in range(mbw):
            i = mby * mbw + mbx
            blk = [0] * 400
            coefs.append(blk)
            is4 = ymode[i] < 0
            if skip[i]:
                tnz_y[4 * mbx:4 * mbx + 4] = [0] * 4
                tnz_u[2 * mbx:2 * mbx + 2] = tnz_v[2 * mbx:2 * mbx + 2] = \
                    [0, 0]
                lnz_y, lnz_u, lnz_v = [0] * 4, [0] * 2, [0] * 2
                if not is4:
                    tnz_dc[mbx] = lnz_dc = 0
                nzs.append(zero_nz)
                continue
            y1dc, y1ac, y2dc, y2ac, uvdc, uvac = quant[seg[i]]
            nz_mb = [0] * 25
            if not is4:
                nz = coeffs(p_y2, tnz_dc[mbx] + lnz_dc, 0, y2dc, y2ac, blk,
                            384)
                tnz_dc[mbx] = lnz_dc = int(nz > 0)
                nz_mb[24] = nz
                first, pac = 1, p_i16
            else:
                first, pac = 0, p_i4
            for y in range(4):
                left = lnz_y[y]
                for x in range(4):
                    c = 4 * mbx + x
                    nz = coeffs(pac, left + tnz_y[c], first, y1dc, y1ac, blk,
                                (4 * y + x) * 16)
                    left = tnz_y[c] = int(nz > first)
                    nz_mb[4 * y + x] = nz
                lnz_y[y] = left
            for k, (tnz, lnz) in enumerate(((tnz_u, lnz_u), (tnz_v, lnz_v))):
                for y in range(2):
                    left = lnz[y]
                    for x in range(2):
                        c = 2 * mbx + x
                        b = 16 + 4 * k + 2 * y + x
                        nz = coeffs(p_uv, left + tnz[c], 0, uvdc, uvac, blk,
                                    b * 16)
                        left = tnz[c] = int(nz > 0)
                        nz_mb[b] = nz
                    lnz[y] = left
            nzs.append(nz_mb)
            if br.eof:
                raise ValueError("VP8 token partition ends early")
    c = np.array(coefs, np.int64).reshape(mbh, mbw, 25, 16)
    c = ((c + 32768) & 0xFFFF) - 32768          # int16, as libwebp stores
    return c, np.array(nzs, np.int64).reshape(mbh, mbw, 25)


def _wht(c):
    """TransformWHT_C of (..., 16) Y2 coefficients -> (..., 16) DCs."""
    a0 = c[..., 0:4] + c[..., 12:16]
    a1 = c[..., 4:8] + c[..., 8:12]
    a2 = c[..., 4:8] - c[..., 8:12]
    a3 = c[..., 0:4] - c[..., 12:16]
    t = np.concatenate([a0 + a1, a3 + a2, a0 - a1, a3 - a2], -1)
    t = t.reshape(*t.shape[:-1], 4, 4)         # rows 0, 4, 8, 12 of tmp
    dc = t[..., 0] + 3
    b0 = dc + t[..., 3]
    b1 = t[..., 1] + t[..., 2]
    b2 = t[..., 1] - t[..., 2]
    b3 = dc - t[..., 3]
    out = np.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], -1) >> 3
    return ((out.reshape(*out.shape[:-2], 16) + 32768) & 0xFFFF) - 32768


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c):
    """TransformOne_C of (..., 16) raster coefficients -> (..., 4, 4)
    residuals (``v >> 3``)."""
    c = c.reshape(*c.shape[:-1], 4, 4)
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = _mul2(c[..., 1, :]) - _mul1(c[..., 3, :])
    d = _mul1(c[..., 1, :]) + _mul2(c[..., 3, :])
    t = np.stack([a + d, b + cc, b - cc, a - d], -1)    # (..., col, k)
    dc = t[..., 0, :] + 4
    a = dc + t[..., 2, :]
    b = dc - t[..., 2, :]
    cc = _mul2(t[..., 1, :]) - _mul1(t[..., 3, :])
    d = _mul1(t[..., 1, :]) + _mul2(t[..., 3, :])
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode, X, A, B, C, D, E, F, G, H, I, J, K, L):  # noqa: E741
    """One 4x4 ``B_PRED`` prediction as 16 values in raster order, from
    the corner X, the eight above A-H and the four left I-L."""
    if mode == DC:
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == TM:
        return [min(max(t + lf - X, 0), 255) for lf in (I, J, K, L)
                for t in (A, B, C, D)]
    if mode == VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)] * 4
    if mode == HE:
        return [v for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                             _avg3(K, L, L)) for _ in range(4)]
    if mode == RD:
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
             _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]
        return [e[3 - y + x] for y in range(4) for x in range(4)]
    if mode == LD:
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
        return [e[x + y] for y in range(4) for x in range(4)]
    if mode == VR:
        return [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D),
                _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C),
                _avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B),
                _avg3(A, B, C)]
    if mode == VL:
        return [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E),
                _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G),
                _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg3(F, G, H)]
    if mode == HD:
        return [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A),
                _avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X),
                _avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]
    # HU
    return [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L),
            _avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L),
            _avg2(K, L), _avg3(K, L, L), L, L,
            L, L, L, L]


def _pred_block(mode, top, left, corner, size, mbx, mby):
    """A 16x16 luma or 8x8 chroma prediction (CheckMode's DC variants)."""
    if mode == DC:
        shift = 5 if size == 16 else 4
        if mbx and mby:
            v = (int(top.sum()) + int(left.sum()) + size) >> shift
        elif mby:
            v = (int(top.sum()) + size // 2) >> (shift - 1)
        elif mbx:
            v = (int(left.sum()) + size // 2) >> (shift - 1)
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == VE:
        return np.broadcast_to(top, (size, size))
    if mode == HE:
        return np.broadcast_to(left[:, None], (size, size))
    return _clip(top[None, :] + left[:, None] - corner)


def _edges(plane, y0, x0, size, mbx, mby):
    """(above, left, corner) of a block at (y0, x0) with libwebp's frame
    edges: 127 above the frame (corner included), 129 left of it."""
    top = plane[y0 - 1, x0:x0 + size] if mby else np.full(size, 127)
    left = plane[y0:y0 + size, x0 - 1] if mbx else np.full(size, 129)
    corner = plane[y0 - 1, x0 - 1] if mbx and mby else 127 if not mby \
        else 129
    return top, left, int(corner)


def _reconstruct(mbw, mbh, ymode, bmodes, uvmode, res):
    """The unfiltered planes (16 mbh, 16 mbw) and two (8 mbh, 8 mbw)."""
    Y = np.zeros((16 * mbh, 16 * mbw), np.int64)
    UV = np.zeros((2, 8 * mbh, 8 * mbw), np.int64)
    res_y, res_uv = _residual_planes(res)
    for mby in range(mbh):
        for mbx in range(mbw):
            i = mby * mbw + mbx
            _intra_mb(Y, UV, mbx, mby, mbw, ymode[i], bmodes[i], uvmode[i],
                      res[mby, mbx], res_y[mby, mbx], res_uv[mby, mbx])
    return Y, UV


def _residual_planes(res):
    """(mbh, mbw, 24, 4, 4) block residuals -> the luma (mbh, mbw, 16, 16)
    and chroma (mbh, mbw, 2, 8, 8) residuals of each macroblock."""
    mbh, mbw = res.shape[:2]
    return (res[:, :, :16].reshape(mbh, mbw, 4, 4, 4, 4)
            .transpose(0, 1, 2, 4, 3, 5).reshape(mbh, mbw, 16, 16),
            res[:, :, 16:].reshape(mbh, mbw, 2, 2, 2, 4, 4)
            .transpose(0, 1, 2, 3, 5, 4, 6).reshape(mbh, mbw, 2, 8, 8))


def _intra_mb(Y, UV, mbx, mby, mbw, ymode, bmodes, uvmode, res, res_y,
              res_uv) -> None:
    """Predict and reconstruct one intra macroblock in place, from the
    unfiltered pixels above and left of it."""
    y0, x0 = 16 * mby, 16 * mbx
    top, left, corner = _edges(Y, y0, x0, 16, mbx, mby)
    if ymode >= 0:
        pred = _pred_block(ymode, top, left, corner, 16, mbx, mby)
        Y[y0:y0 + 16, x0:x0 + 16] = _clip(pred + res_y)
    else:
        Y[y0:y0 + 16, x0:x0 + 16] = _bpred(
            bmodes, top, left, corner, _top_right(Y, y0, x0, mbx, mby, mbw),
            res[:16].reshape(16, 16).tolist())
    c0, c1 = 8 * mby, 8 * mbx
    for p in range(2):
        top, left, corner = _edges(UV[p], c0, c1, 8, mbx, mby)
        pred = _pred_block(uvmode, top, left, corner, 8, mbx, mby)
        UV[p, c0:c0 + 8, c1:c1 + 8] = _clip(pred + res_uv[p])


def _top_right(Y, y0, x0, mbx, mby, mbw):
    """The four pixels above and right of a macroblock: 127 on the first
    row, the last above pixel repeated on the last column."""
    if not mby:
        return [127] * 4
    if mbx == mbw - 1:
        return [int(Y[y0 - 1, x0 + 15])] * 4
    return Y[y0 - 1, x0 + 16:x0 + 20].tolist()


def _bpred(modes, top, left, corner, top_right, res):
    """A ``B_PRED`` macroblock: the 16 sub-blocks predicted and
    reconstructed in turn in a 17 x 21 working area (row 0 and column 0 the
    edges, the above-right pixels repeated at rows 4, 8 and 12)."""
    W = [[0] * 21 for _ in range(17)]
    W[0] = [corner] + top.tolist() + top_right
    for r in range(16):
        W[r + 1][0] = int(left[r])
    for r in (4, 8, 12):
        W[r][17:21] = top_right
    for b in range(16):
        by, bx = divmod(b, 4)
        r, c = 4 * by + 1, 4 * bx + 1
        above = W[r - 1][c - 1:c + 8]
        pred = _pred4(modes[b], *above, W[r][c - 1], W[r + 1][c - 1],
                      W[r + 2][c - 1], W[r + 3][c - 1])
        rb = res[b]
        for y in range(4):
            row = W[r + y]
            for x in range(4):
                v = pred[4 * y + x] + rb[4 * y + x]
                row[c + x] = 0 if v < 0 else 255 if v > 255 else v
    return np.array([row[1:17] for row in W[1:]], np.int64)


# ------------------------------------------------------------ loop filter
def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _filter2(p1, p0, q0, q1):
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    return _clip(p0 + a2), _clip(q0 - a1)


def _simple_edge(s, limit):
    """SimpleVFilter16 on a (16, 8) view of p3..q3 (columns)."""
    p1, p0, q0, q1 = s[..., 2], s[..., 3], s[..., 4], s[..., 5]
    m = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * limit + 1
    if m.any():
        np0, nq0 = _filter2(p1, p0, q0, q1)
        s[..., 3] = np.where(m, np0, p0)
        s[..., 4] = np.where(m, nq0, q0)


def _normal_edge(s, limit, ilimit, hev_t, mb_edge):
    """FilterLoop26 (macroblock edge) or FilterLoop24 (inner edge) on a
    (..., 8) view of p3 p2 p1 p0 q0 q1 q2 q3."""
    p3, p2, p1, p0 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    q0, q1, q2, q3 = s[..., 4], s[..., 5], s[..., 6], s[..., 7]
    m = (4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * limit + 1) \
        & (np.abs(p3 - p2) <= ilimit) & (np.abs(p2 - p1) <= ilimit) \
        & (np.abs(p1 - p0) <= ilimit) & (np.abs(q3 - q2) <= ilimit) \
        & (np.abs(q2 - q1) <= ilimit) & (np.abs(q1 - q0) <= ilimit)
    if not m.any():
        return
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    h0, hq = _filter2(p1, p0, q0, q1)
    if mb_edge:
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = [_clip(p2 + a3), _clip(p1 + a2), _clip(p0 + a1),
               _clip(q0 - a1), _clip(q1 - a2), _clip(q2 - a3)]
    else:
        a = 3 * (q0 - p0)
        a1 = _sclip2((a + 4) >> 3)
        a2 = _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        new = [p2, _clip(p1 + a3), _clip(p0 + a2), _clip(q0 - a1),
               _clip(q1 - a3), q2]
    new[2] = np.where(hev, h0, new[2])
    new[3] = np.where(hev, hq, new[3])
    for k in (0, 1, 4, 5):
        new[k] = np.where(hev, s[..., k + 1], new[k])
    for k in range(6):
        s[..., k + 1] = np.where(m, new[k], s[..., k + 1])


def _edge_index(ys, xs, size: int, offset: int, vertical: bool):
    """Row and column indices (n, size, 8) gathering, for the macroblocks
    whose top-left pixels are (ys, xs), the pixels p3..q3 across each one's
    edge at ``offset`` (0: the macroblock edge): columns around a vertical
    edge, rows around a horizontal one."""
    k = np.arange(size)[None, :, None]
    j = np.arange(-4, 4)[None, None, :]
    y, x = ys[:, None, None], xs[:, None, None]
    if vertical:
        return np.broadcast_arrays(y + k, x + offset + j)
    return np.broadcast_arrays(y + offset + j, x + k)


def _filter_plane(plane, ys, xs, size, params, simple=False):
    """DoFilter's edges of the macroblocks at (ys, xs) of one plane, in its
    order (left, inner vertical, top, inner horizontal), each edge at once
    for all of them; ``params`` (n, 4): limit, interior limit, hev
    threshold, inner edges."""
    limit, ilimit, hev_t = (params[:, i:i + 1] for i in range(3))
    inner = params[:, 3].astype(bool)
    for vertical in (True, False):
        first = (xs if vertical else ys) > 0
        for offset in range(0, size, 4):
            sel = first if offset == 0 else inner
            if not sel.any():
                continue
            rows, cols = _edge_index(ys[sel], xs[sel], size, offset, vertical)
            s = plane[..., rows, cols]
            lim = limit[sel] + (4 if offset == 0 else 0)
            if simple:
                _simple_edge(s, lim)
            else:
                _normal_edge(s, lim, ilimit[sel], hev_t[sel], offset == 0)
            plane[..., rows, cols] = s


def _loop_filter(Y, UV, hdr, mbw, mbh, strengths):
    """DoFilter for every macroblock, in place. A macroblock's filtering
    reads what its left, upper and upper-right neighbours' left wrote, so
    the macroblocks of one anti-diagonal x + 2y, whose pixels do not
    overlap, are filtered together, diagonal by diagonal: the result of
    libwebp's raster order. The simple filter touches luma only."""
    S = np.array(strengths, np.int64).reshape(mbh, mbw, 4)
    for t in range(mbw + 2 * (mbh - 1)):
        ys = np.arange(max(0, (t - mbw + 2) // 2), min(mbh, t // 2 + 1))
        xs = t - 2 * ys
        keep = (xs < mbw) & (S[ys, np.minimum(xs, mbw - 1), 0] > 0)
        ys, xs = ys[keep], xs[keep]
        if not len(ys):
            continue
        params = S[ys, xs]
        _filter_plane(Y, 16 * ys, 16 * xs, 16, params, hdr.filter_type == 1)
        if hdr.filter_type == 2:
            _filter_plane(UV, 8 * ys, 8 * xs, 8, params)


def decode_frame(data: bytes, start: int, size: int) -> Frame:
    """The key frame whose chunk starts at ``data[start]`` and declares
    ``size`` bytes; as in libwebp, the last partition runs on to the end
    of ``data``."""
    w, h = frame_size(data, start, size)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    first = (data[start] | data[start + 1] << 8 | data[start + 2] << 16) >> 5
    pos = start + 10
    end = len(data)
    if first > end - pos:
        raise ValueError("VP8 first partition truncated")
    br = BoolDecoder(data, pos, pos + first)
    hdr = _Header(br)
    pos += first
    n_sizes = hdr.partitions - 1
    if end - pos < 3 * n_sizes:
        raise ValueError("VP8 partition sizes truncated")
    part_start = pos + 3 * n_sizes
    parts = []
    for p in range(n_sizes):
        psize = data[pos + 3 * p] | data[pos + 3 * p + 1] << 8 \
            | data[pos + 3 * p + 2] << 16
        psize = min(psize, end - part_start)
        parts.append(BoolDecoder(data, part_start, part_start + psize))
        part_start += psize
    if part_start >= end:
        raise ValueError("VP8 last partition is empty")
    parts.append(BoolDecoder(data, part_start, end))
    quant = hdr.read_quant(br)
    br.bit(128)                                # refresh entropy probs
    probs = _read_probs(br)
    skip_prob = br.literal(8) if br.bit(128) else None
    seg, skip, ymode, bmodes, uvmode = _read_modes(br, hdr, mbw, mbh,
                                                   skip_prob)
    coefs, nz = _read_tokens(parts, mbw, mbh, probs, quant, seg, skip, ymode)
    i16 = (np.array(ymode) >= 0).reshape(mbh, mbw)
    coefs[:, :, :16, 0] = np.where(i16[..., None], _wht(coefs[:, :, 24]),
                                   coefs[:, :, :16, 0])
    res = _idct(coefs[:, :, :24])
    Y, UV = _reconstruct(mbw, mbh, ymode, bmodes, uvmode, res)
    tools = _tools(hdr, seg, skip, ymode, bmodes, uvmode)
    if hdr.filter_type:
        # a macroblock's inner edges are filtered if it is B_PRED or any
        # block has coefficients (NzCodeBits: nz > 1 or a non-zero DC)
        coded = ((nz[..., :24] > 1) | (coefs[:, :, :24, 0] != 0)).any(-1)
        coded &= ~np.array(skip, bool).reshape(mbh, mbw)
        fs = hdr.filter_strengths()
        strengths = [[fs[seg[i]][ymode[i] < 0][:3]
                      + (ymode[i] < 0 or bool(coded.flat[i]),)
                      for i in range(r * mbw, (r + 1) * mbw)]
                     for r in range(mbh)]
        _loop_filter(Y, UV, hdr, mbw, mbh, strengths)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return Frame(Y[:h, :w].astype(np.uint8), UV[0, :ch, :cw].astype(np.uint8),
                 UV[1, :ch, :cw].astype(np.uint8), tools)


def _tools(hdr, seg, skip, ymode, bmodes, uvmode) -> dict:
    """What the frame used, for the fixtures' manifest."""
    y16 = [m for m in ymode if m >= 0]
    b4 = [m for ms in bmodes if ms for m in ms]
    return {
        "filter": ("none", "simple", "normal")[hdr.filter_type],
        "sharpness": hdr.sharpness, "partitions": hdr.partitions,
        "segments": len(set(seg)) if hdr.update_map else int(hdr.segments),
        "lf_delta": int(hdr.use_lf_delta),
        "skipped": int(sum(skip)),
        "i16": {MODE_NAMES[m]: y16.count(m) for m in range(4) if m in y16},
        "b_pred": {MODE_NAMES[m]: b4.count(m) for m in range(10) if m in b4},
        "uv": {MODE_NAMES[m]: uvmode.count(m) for m in range(4)
               if m in uvmode}}
