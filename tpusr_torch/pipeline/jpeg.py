"""JPEG decode in numpy, beside ``pipeline/png.py``.

The JAX package decodes request bodies and dataset files with OpenCV, which
decodes JPEG through libjpeg-turbo. The port has no image library, so it
carries this decoder, written to give what ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)`` gives (swapped to RGB), bit for bit:

- Huffman-coded JPEG at 8 bits: baseline (SOF0) and extended sequential
  (SOF1: four tables of each kind), one scan or one scan per component;
  progressive (SOF2: DC first and refinement scans, AC first scans with
  end-of-band runs, AC refinement scans with their correction bits, as in
  libjpeg's ``jdphuff.c``); restart intervals in both;
- gray, YCbCr, RGB (an Adobe transform of 0, or components named R, G, B
  and no JFIF marker), CMYK and YCCK (four components, an Adobe transform
  of 0 or 2), given as OpenCV gives them: libjpeg's ``JCS_CMYK`` output
  through OpenCV's ``icvCvt_CMYK2BGR``;
- every integral sampling ratio: libjpeg's "fancy" triangle upsampling at
  h2v1, h1v2 and h2v2 (box replication where the chroma is at most two
  samples wide), box replication (``int_upsample``) at any other ratio;
- libjpeg's integer IDCT (``JDCT_ISLOW``, ``jidctint.c``) with its range
  limit and its fixed-point YCbCr->RGB tables (``jdcolor.c``);
- the EXIF orientation tag (APP1), applied as ``cv2.imdecode`` applies it.

Huffman decoding is a Python loop over symbols, on a precomputed 16-bit
window of the entropy-coded bits and 16-bit lookup tables; dequantisation,
the IDCT, upsampling and colour run over all blocks at once in numpy.

Arithmetic-coded, lossless, hierarchical and 12-bit JPEG, a sequential
component coded in two scans, and a progressive JPEG whose scans leave a
coefficient bit unrefined (where libjpeg smooths the blocks) raise
``ValueError`` naming what they are.

The decoder faces the network, so what a body declares is checked before
memory is sized from it: an image over 2^30 pixels is refused (OpenCV's
``CV_IO_MAX_IMAGE_PIXELS``), and so is a frame of another size than the
caller's ``expected_hw``; a component's coefficients are allocated by the
first scan that codes it, and only once that scan is known to carry at
least one bit for each of its blocks (two in a sequential scan: a DC and an
AC code; one in a progressive DC scan; a progressive component's first scan
must be a DC scan), so a few bytes cannot declare megabytes of blocks; only
the bytes a scan's blocks could read are windowed; Huffman tables are built
when a scan uses them.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

SOI = b"\xff\xd8"
# the zig-zag order's natural index of each coded coefficient, with libjpeg's
# 16 extra entries that send a corrupt run past 63 to coefficient 63
_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
            12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
            35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
            58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] \
    + [63] * 16
_SOF_REFUSED = {0xC3: "lossless", 0xC5: "differential",
                0xC6: "differential progressive", 0xC7: "differential lossless",
                0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded differential",
                0xCE: "arithmetic-coded differential progressive",
                0xCF: "arithmetic-coded differential lossless"}
# jidctint.c's constants, FIX(x) at CONST_BITS 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172
# OpenCV's CV_IO_MAX_IMAGE_PIXELS: cv2.imdecode refuses a larger image
MAX_PIXELS = 1 << 30
# the most bits one block can read: 64 codes of at most 16 bits, each with
# at most 15 extra bits
_MAX_BLOCK_BITS = 64 * (16 + 15)
# libjpeg's D_MAX_BLOCKS_IN_MCU
_MAX_BLOCKS_IN_MCU = 10


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT range limit (``prepare_range_limit_table``),
    indexed by the descaled value masked to 10 bits."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)      # the mask's two's complement
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def _ycc_tables():
    """jdcolor.c's ``build_ycc_rgb_table`` (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


class _Huffman:
    """A Huffman table as 16-bit lookup lists: the code length and the
    symbol of every 16-bit window that starts with a code (an invalid code
    reads as symbol 0 of length 16, as libjpeg reads it); and, where the
    code and its s extra bits fit in the window, the bits they take in all
    (``fast_len``, 0 where they do not fit), the zero run and the extended
    value, so that one lookup decodes a coefficient (``dc``: every category,
    0 included; AC: s > 0, so EOB and ZRL take the slow path)."""

    def __init__(self, counts: bytes, symbols: bytes, dc: bool):
        if dc and any(v > 15 for v in symbols):
            raise ValueError("JPEG DC Huffman table has a category above 15")
        length = np.full(1 << 16, 16, np.int64)
        symbol = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for n_bits in range(1, 17):
            for _ in range(counts[n_bits - 1]):
                lo = code << (16 - n_bits)
                hi = (code + 1) << (16 - n_bits)
                if hi > 1 << 16:
                    raise ValueError("JPEG Huffman table has a bad code")
                length[lo:hi] = n_bits
                symbol[lo:hi] = symbols[k]
                code += 1
                k += 1
            code <<= 1
        s, total = symbol & 15, length + (symbol & 15)
        fits = (total <= 16) & (length < 16) & ((s > 0) | dc)
        w = np.arange(1 << 16)
        v = (w >> np.clip(16 - total, 0, 16)) & ((1 << s) - 1)
        v = np.where((s > 0) & (v < (1 << np.maximum(s - 1, 0))),
                     v - (1 << s) + 1, v)
        self.length = length.tolist()
        self.symbol = symbol.tolist()
        self.fast_len = np.where(fits, total, 0).tolist()
        self.fast_run = (symbol >> 4).tolist()
        self.fast_val = np.where(fits, v, 0).tolist()


@functools.lru_cache(maxsize=8)
def _huffman(counts: bytes, symbols: bytes, dc: bool) -> _Huffman:
    """The table of a DHT entry, built when a scan uses it; most encoders
    send the same few (the standard tables of Annex K), so their lookup
    lists are built once."""
    return _Huffman(counts, symbols, dc)


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None           # its quantisation table, latched at its scan


class _Frame:
    def __init__(self, data: bytes, expected_hw: tuple[int, int] | None,
                 progressive: bool = False):
        if len(data) < 6:
            raise ValueError("truncated JPEG frame header")
        precision, self.height, self.width, n = struct.unpack(">BHHB", data[:6])
        self.progressive = progressive
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not supported "
                             f"(8-bit only)")
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG with no height (a DNL marker) or no width "
                             "is not supported")
        if self.height * self.width > MAX_PIXELS:
            raise ValueError(f"JPEG of {self.height}x{self.width} is over "
                             f"2^30 pixels (OpenCV's limit)")
        if expected_hw is not None and (self.height, self.width) not in (
                tuple(expected_hw), tuple(expected_hw)[::-1]):
            raise ValueError(f"expected {expected_hw[0]}x{expected_hw[1]} "
                             f"LR input, got a {self.height}x{self.width} "
                             f"JPEG")
        if n not in (1, 3, 4):
            raise ValueError(f"JPEG with {n} components is not supported")
        if len(data) != 6 + 3 * n:
            raise ValueError("JPEG frame header of the wrong length")
        self.comps = []
        for i in range(n):
            cid, hv, tq = data[6 + 3 * i: 9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise ValueError(f"JPEG sampling factors {h}x{v} are invalid")
            self.comps.append(_Component(cid, h, v, tq))
        self.max_h = max(c.h for c in self.comps)
        self.max_v = max(c.v for c in self.comps)
        for c in self.comps:
            if self.max_h % c.h or self.max_v % c.v:
                raise ValueError(
                    f"JPEG subsampling of {self.max_h}/{c.h}x{self.max_v}/"
                    f"{c.v} (component {c.id} at h{c.h}v{c.v}) is a "
                    f"fractional ratio, which libjpeg does not upsample")
        self.mcus_wide = -(-self.width // (8 * self.max_h))
        self.mcus_high = -(-self.height // (8 * self.max_v))
        for c in self.comps:
            # libjpeg's jdinput.c geometry
            c.blocks_wide = -(-self.width * c.h // (8 * self.max_h))
            c.blocks_high = -(-self.height * c.v // (8 * self.max_v))
            c.dw = -(-self.width * c.h // self.max_h)
            c.dh = -(-self.height * c.v // self.max_v)
            c.rows, c.cols = self.mcus_high * c.v, self.mcus_wide * c.h
            c.coef = None       # allocated by the scan that codes it
            c.flat = None       # a progressive component's coefficients
            c.coef_bits = [-1] * 64     # libjpeg's coef_bits, per position


def _segments(body: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded segments of the scan that starts at ``pos``, split
    at its restart markers and unstuffed, and the position of the marker
    that ends the scan."""
    segs, start = [], pos
    while True:
        i = body.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(body):
            raise ValueError("truncated JPEG: the scan has no end marker")
        nxt = body[i + 1]
        if nxt == 0x00:             # a stuffed 0xFF data byte
            pos = i + 2
            continue
        j = i
        while j + 1 < len(body) and body[j + 1] == 0xFF:
            j += 1                  # fill bytes before a marker
        if j + 1 >= len(body):
            raise ValueError("truncated JPEG: the scan has no end marker")
        segs.append(body[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= body[j + 1] <= 0xD7:       # RSTn
            start = pos = j + 2
            continue
        return segs, j


def _bit_windows(segs: list[bytes]) -> tuple[list[int], list[int]]:
    """The 16 bits from every bit position of the segments laid end to end,
    each followed by zero bytes (libjpeg reads zeros past a segment's end),
    and the bit position where each segment starts."""
    starts, parts, n = [], [], 0
    for s in segs:
        starts.append(8 * n)
        parts.append(s + b"\x00\x00\x00\x00")
        n += len(s) + 4
    data = np.frombuffer(b"".join(parts) + b"\x00\x00", np.uint8).astype(np.int64)
    v24 = (data[:-2] << 16) | (data[1:-1] << 8) | data[2:]
    win = (v24[:, None] >> (8 - np.arange(8))) & 0xFFFF
    return win.reshape(-1).tolist(), starts


def _scan_plan(frame: _Frame, comps: list[_Component]):
    """The slot (component in the scan) of each block of one MCU, and each
    coded block's flat coefficient offset, in the scan's order."""
    if len(comps) == 1:
        c = comps[0]
        rr, cc = np.meshgrid(np.arange(c.blocks_high), np.arange(c.blocks_wide),
                             indexing="ij")
        return [0], (64 * (rr * c.cols + cc)).ravel().tolist()
    slots, parts = [], []
    my = np.arange(frame.mcus_high)[:, None, None, None]
    mx = np.arange(frame.mcus_wide)[None, :, None, None]
    for slot, c in enumerate(comps):
        by = np.arange(c.v)[None, None, :, None]
        bx = np.arange(c.h)[None, None, None, :]
        base = 64 * ((my * c.v + by) * c.cols + mx * c.h + bx)
        parts.append(base.reshape(frame.mcus_high, frame.mcus_wide, -1))
        slots += [slot] * (c.v * c.h)
    return slots, np.concatenate(parts, axis=2).ravel().tolist()


def _scan_header(frame: _Frame, header: bytes):
    """The components of a scan, their (DC, AC) table ids and the scan's
    Ss, Se, Ah and Al."""
    n = header[0] if header else 0
    if not 1 <= n <= len(frame.comps) or len(header) != 4 + 2 * n:
        raise ValueError("JPEG scan header is malformed")
    comps, tabs = [], []
    for i in range(n):
        cid, t = header[1 + 2 * i], header[2 + 2 * i]
        c = next((c for c in frame.comps if c.id == cid), None)
        if c is None:
            raise ValueError(f"JPEG scan names an unknown component {cid}")
        if c in comps:
            raise ValueError(f"JPEG scan names component {cid} twice")
        comps.append(c)
        tabs.append((t >> 4, t & 15))
    if n > 1 and sum(c.h * c.v for c in comps) > _MAX_BLOCKS_IN_MCU:
        raise ValueError("JPEG scan of more than 10 blocks an MCU")
    ss, se, a = header[1 + 2 * n: 4 + 2 * n]
    return comps, tabs, ss, se, a >> 4, a & 15


def _scan_extent(frame: _Frame, comps: list[_Component]) -> tuple[int, int]:
    """(MCUs, blocks an MCU) of a scan: one block an MCU in a scan of one
    component, else the frame's MCUs."""
    if len(comps) == 1:
        return comps[0].blocks_high * comps[0].blocks_wide, 1
    return (frame.mcus_high * frame.mcus_wide,
            sum(c.h * c.v for c in comps))


def _scan_segments(body: bytes, pos: int, n_mcu: int, mcu_blocks: int,
                   restart: int, min_bits: int):
    """The segments of the scan at ``pos`` that its MCUs read, each cut to
    the bytes its blocks could read; the position of the marker after the
    scan. A scan that carries fewer than ``min_bits`` bits for each block
    is cut short, and is refused before anything is sized from it."""
    segs, end = _segments(body, pos)
    # segments past the last restart interval are never read
    per_seg = restart if restart else n_mcu
    segs = segs[:-(-n_mcu // per_seg)]
    bits = 8 * sum(len(s) for s in segs)
    if min_bits * n_mcu * mcu_blocks > bits:
        raise ValueError(f"truncated JPEG scan: {n_mcu * mcu_blocks} blocks "
                         f"in {bits} bits")
    # a segment's blocks read at most _MAX_BLOCK_BITS each: the bytes past
    # them are never read
    cap = per_seg * mcu_blocks * _MAX_BLOCK_BITS // 8 + 8
    return [s[:cap] for s in segs], end


def _decode_scan(body: bytes, pos: int, frame: _Frame, header: bytes,
                 dc_tabs: dict, ac_tabs: dict, qtabs: dict,
                 restart: int) -> int:
    """Huffman-decode one sequential scan into its components'
    coefficients; returns the position of the marker after it."""
    comps, tabs, ss, se, ah, al = _scan_header(frame, header)
    n = len(comps)
    for c, (d, t) in zip(comps, tabs):
        if c.q is not None:
            raise ValueError(f"JPEG component {c.id} is coded in two scans")
        if d not in dc_tabs or t not in ac_tabs:
            raise ValueError("JPEG scan uses an undefined Huffman table")
        if c.tq not in qtabs:
            raise ValueError("JPEG component uses an undefined quantisation "
                             "table")
    if (ss, se, ah, al) != (0, 63, 0, 0):
        raise ValueError("JPEG sequential scan with a spectral band or "
                         "successive approximation is invalid")
    n_mcu, mcu_blocks = _scan_extent(frame, comps)
    # every block reads a DC and an AC code of one bit or more
    segs, end = _scan_segments(body, pos, n_mcu, mcu_blocks, restart, 2)
    for c in comps:
        c.q = qtabs[c.tq]
        c.coef = np.zeros((c.rows, c.cols, 64), np.int64)
    tabs = [(_huffman(*dc_tabs[d], True), _huffman(*ac_tabs[t], False))
            for d, t in tabs]
    win, starts = _bit_windows(segs)
    mcu_slots, bases = _scan_plan(frame, comps)
    flats = [c.coef.reshape(-1) for c in comps]
    coefs = [[0] * len(f) for f in flats]
    # per block of the MCU: its component's slot, output list and tables
    slots = []
    for slot in mcu_slots:
        dc, ac = tabs[slot]
        slots.append((slot, coefs[slot], dc.length, dc.symbol, dc.fast_len,
                      dc.fast_val, ac.length, ac.symbol, ac.fast_len,
                      ac.fast_run, ac.fast_val))
    natural = _NATURAL
    pred = [0] * n
    seg, bit, i = 0, starts[0], 0
    try:
        for m in range(n_mcu):
            if restart and m and m % restart == 0:
                seg += 1
                pred = [0] * n
                bit = starts[seg] if seg < len(starts) else len(win) - 16
            for (slot, out, dl, ds, dfl, dfv, al, asym, afl, afr,
                 afv) in slots:
                base = bases[i]
                i += 1
                w = win[bit]
                nb = dfl[w]
                if nb:
                    pred[slot] += dfv[w]
                    bit += nb
                else:
                    s = ds[w]
                    bit += dl[w]
                    if s:
                        v = win[bit] >> (16 - s)
                        bit += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        pred[slot] += v
                out[base] = pred[slot]
                k = 1
                while k < 64:
                    w = win[bit]
                    nb = afl[w]
                    if nb:
                        k += afr[w]
                        out[base + natural[k]] = afv[w]
                        k += 1
                        bit += nb
                        continue
                    rs = asym[w]
                    bit += al[w]
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        v = win[bit] >> (16 - s)
                        bit += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        out[base + natural[k]] = v
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break
    except IndexError:
        raise ValueError("truncated or corrupt JPEG scan data") from None
    for f, vals in zip(flats, coefs):
        f[:] = vals
    return end


def _decode_progressive_scan(body: bytes, pos: int, frame: _Frame,
                             header: bytes, dc_tabs: dict, ac_tabs: dict,
                             qtabs: dict, restart: int) -> int:
    """Huffman-decode one progressive scan (``jdphuff.c``) into its
    components' coefficient lists; returns the position of the marker after
    it. As libjpeg, an MCU that starts after its segment's data ran out is
    left as it was."""
    comps, tabs, ss, se, ah, al = _scan_header(frame, header)
    dc_band = ss == 0
    if (se != 0 if dc_band else (ss > se or se > 63 or len(comps) != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"JPEG progression Ss={ss} Se={se} Ah={ah} Al={al} "
                         f"is invalid")
    for c, (d, t) in zip(comps, tabs):
        if dc_band and not ah and d not in dc_tabs or \
                not dc_band and t not in ac_tabs:
            raise ValueError("JPEG scan uses an undefined Huffman table")
        if c.q is None and c.tq not in qtabs:
            raise ValueError("JPEG component uses an undefined quantisation "
                             "table")
        if c.flat is None and not dc_band:
            raise ValueError(f"progressive JPEG component {c.id} has an AC "
                             f"scan before its DC scan")
    n_mcu, mcu_blocks = _scan_extent(frame, comps)
    # a DC scan reads a code or a bit for each block; an AC scan may cover
    # 32767 blocks with one end-of-band run
    segs, end = _scan_segments(body, pos, n_mcu, mcu_blocks, restart,
                               1 if dc_band else 0)
    for c in comps:
        if c.q is None:         # libjpeg's latch_quant_tables
            c.q = qtabs[c.tq]
        if c.flat is None:
            c.flat = [0] * (c.rows * c.cols * 64)
        for k in range(ss, se + 1):
            c.coef_bits[k] = al
    win, starts = _bit_windows(segs)
    ends = [st + 8 * len(sg) for st, sg in zip(starts, segs)]
    mcu_slots, bases = _scan_plan(frame, comps)
    outs = [c.flat for c in comps]
    natural = _NATURAL
    p1, m1 = 1 << al, -1 << al
    seg, bit, i = 0, starts[0], 0
    pred = [0] * len(comps)
    eobrun = 0
    if dc_band and not ah:
        dcs = [_huffman(*dc_tabs[d], True) for d, _ in tabs]
    elif not dc_band:
        ac = _huffman(*ac_tabs[tabs[0][1]], False)
        al_, asym, afl, afr, afv = (ac.length, ac.symbol, ac.fast_len,
                                    ac.fast_run, ac.fast_val)
        out = outs[0]
    try:
        for m in range(n_mcu):
            if restart and m and m % restart == 0:
                seg += 1
                pred = [0] * len(comps)
                eobrun = 0
                bit = starts[seg] if seg < len(starts) else len(win) - 16
            if bit > ends[min(seg, len(ends) - 1)]:     # insufficient data
                i += mcu_blocks
                continue
            if dc_band:
                for slot in mcu_slots:
                    base = bases[i]
                    i += 1
                    o = outs[slot]
                    if ah:                       # DC refinement: one bit
                        if win[bit] >> 15:
                            o[base] |= p1
                        bit += 1
                        continue
                    dc = dcs[slot]
                    w = win[bit]
                    nb = dc.fast_len[w]
                    if nb:
                        pred[slot] += dc.fast_val[w]
                        bit += nb
                    else:
                        sz = dc.symbol[w]
                        bit += dc.length[w]
                        if sz:
                            v = win[bit] >> (16 - sz)
                            bit += sz
                            if v < (1 << (sz - 1)):
                                v -= (1 << sz) - 1
                            pred[slot] += v
                    o[base] = pred[slot] << al
                continue
            base = bases[i]
            i += 1
            if not ah:                           # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    w = win[bit]
                    nb = afl[w]
                    if nb:
                        k += afr[w]
                        out[base + natural[k]] = afv[w] << al
                        k += 1
                        bit += nb
                        continue
                    rs = asym[w]
                    bit += al_[w]
                    r, sz = rs >> 4, rs & 15
                    if sz:
                        k += r
                        v = win[bit] >> (16 - sz)
                        bit += sz
                        if v < (1 << (sz - 1)):
                            v -= (1 << sz) - 1
                        out[base + natural[k]] = v << al
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += win[bit] >> (16 - r)
                            bit += r
                        eobrun -= 1
                        break
                continue
            k = ss                               # AC refinement
            if not eobrun:
                while k <= se:
                    rs = asym[win[bit]]
                    bit += al_[win[bit]]
                    r, sz = rs >> 4, rs & 15
                    if sz:
                        sz = p1 if win[bit] >> 15 else m1
                        bit += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += win[bit] >> (16 - r)
                            bit += r
                        break
                    while k <= se:
                        at = base + natural[k]
                        cur = out[at]
                        if cur:
                            if win[bit] >> 15 and not cur & p1:
                                out[at] = cur + (p1 if cur >= 0 else m1)
                            bit += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if sz:
                        out[base + natural[k]] = sz
                    k += 1
            if eobrun:
                while k <= se:
                    at = base + natural[k]
                    cur = out[at]
                    if cur:
                        if win[bit] >> 15 and not cur & p1:
                            out[at] = cur + (p1 if cur >= 0 else m1)
                        bit += 1
                    k += 1
                eobrun -= 1
    except IndexError:
        raise ValueError("truncated or corrupt JPEG scan data") from None
    return end


def _idct_1d(c):
    """jidctint.c's 1-D stage on 8 arrays (the even part from c[0], c[2],
    c[4], c[6], the odd part from the rest); returns the 8 sums before the
    descale, in output order."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised (..., 8, 8) int coefficients (row = vertical frequency)
    -> (..., 8, 8) uint8 samples, as libjpeg's ``jpeg_idct_islow``."""
    coef = coef.astype(np.int64)
    # pass 1: columns, kept at PASS1_BITS more precision
    cols = _idct_1d([coef[..., u, :] for u in range(8)])
    ws = np.stack([_descale(x, _CONST_BITS - _PASS1_BITS) for x in cols],
                  axis=-2)
    # pass 2: rows
    rows = _idct_1d([ws[..., :, u] for u in range(8)])
    out = np.stack([_descale(x, _CONST_BITS + _PASS1_BITS + 3) for x in rows],
                   axis=-1)
    return _RANGE_LIMIT[out & 1023]


def _plane(c: _Component) -> np.ndarray:
    """A component's samples at its own resolution, cropped to its
    downsampled size."""
    blocks = c.coef * c.q[None, None, :]
    px = idct_islow(blocks.reshape(c.rows, c.cols, 8, 8))
    px = px.transpose(0, 2, 1, 3).reshape(c.rows * 8, c.cols * 8)
    return px[:c.dh, :c.dw]


def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    x = p.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_h1v2(p: np.ndarray) -> np.ndarray:
    x = p.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (3 * x + up + 1) >> 2
    out[1::2] = (3 * x + down + 2) >> 2
    return out


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    x = p.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, near in ((0, up), (1, down)):
        col = 3 * x + near                       # the vertical triangle
        left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * col + left + 8) >> 4
        out[r::2, 1::2] = (3 * col + right + 7) >> 4
    return out


def _upsample(c: _Component, frame: _Frame) -> np.ndarray:
    """A component brought to the full grid (libjpeg's ``jdsample.c``:
    fancy h2v1/h1v2/h2v2, box replication where the chroma is at most two
    samples wide and at every other ratio), cropped to the image."""
    p = _plane(c)
    rh, rv = frame.max_h // c.h, frame.max_v // c.v
    fancy_wide = c.dw > 2
    if (rh, rv) == (2, 1) and fancy_wide:
        p = _fancy_h2v1(p)
    elif (rh, rv) == (1, 2):
        p = _fancy_h1v2(p)
    elif (rh, rv) == (2, 2) and fancy_wide:
        p = _fancy_h2v2(p)
    elif (rh, rv) != (1, 1):
        p = np.repeat(np.repeat(p, rv, axis=0), rh, axis=1)
    return p[:frame.height, :frame.width].astype(np.int64)


def exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of the IFD0 of an Exif TIFF block (an
    APP1 payload after its ``Exif\\0\\0``, or a PNG's eXIf chunk), or 1."""
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or len(tiff) < 8:
        return 1
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd: ifd + 2])
        for k in range(count):
            e = ifd + 2 + 12 * k
            tag, typ = struct.unpack(order + "HH", tiff[e: e + 4])
            if tag == 0x0112 and typ == 3:
                (val,) = struct.unpack(order + "H", tiff[e + 8: e + 10])
                return val if 1 <= val <= 8 else 1
    except struct.error:
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` on an (h, w, c) image."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg_u8(body: bytes,
                   expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) uint8 RGB (see the module docstring). With
    ``expected_hw``, a frame of another size (in either orientation, since
    the EXIF tag may transpose it) is refused before any table or scan is
    decoded."""
    frame, orientation = parse_jpeg(body, expected_hw)
    planes = [_upsample(c, frame) for c in frame.comps]
    space = frame.colorspace
    if space == "gray":
        rgb = np.repeat(planes[0][..., None], 3, axis=-1)
    elif space in ("rgb", "cmyk"):
        rgb = np.stack(planes[:3], axis=-1)
    else:
        y, cb, cr = planes[:3]
        rgb = np.clip(np.stack([y + _CR_R[cr],
                                y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                                y + _CB_B[cb]], axis=-1), 0, 255)
        if space == "ycck":             # jdcolor.c's ycck_cmyk_convert
            rgb = 255 - rgb
    if space in ("cmyk", "ycck"):
        # OpenCV's icvCvt_CMYK2BGR on libjpeg's JCS_CMYK samples
        k = planes[3][..., None]
        rgb = k - (((255 - rgb) * k) >> 8)
    return apply_orientation(rgb.astype(np.uint8), orientation)


def parse_jpeg(body: bytes, expected_hw: tuple[int, int] | None = None):
    """Parse a JPEG and Huffman-decode its scans: returns (frame, EXIF
    orientation); each of ``frame.comps`` holds its quantised coefficients
    ``coef`` ((rows, cols, 64) blocks in natural order) and its table ``q``
    (natural order), ``dh`` x ``dw`` of its samples are in the image, and
    ``frame.max_h`` / ``frame.max_v`` over its ``h`` / ``v`` give its
    subsampling; ``frame.colorspace`` is what libjpeg takes it for. Every
    refusal of ``decode_jpeg_u8`` is made here; a truncated progressive
    file is refused as unrefined (libjpeg decodes what arrived, smoothed)."""
    frames = []
    try:
        return _parse_jpeg(body, expected_hw, frames)
    except ValueError as e:
        if frames and frames[0].progressive and str(e).startswith("truncated"):
            raise ValueError(f"unrefined progressive JPEG: {e}") from None
        raise


def _parse_jpeg(body: bytes, expected_hw, frames: list):
    if not body.startswith(SOI):
        raise ValueError("not a JPEG image (no SOI marker)")
    pos, frame, restart = 2, None, 0
    qtabs, dc_tabs, ac_tabs = {}, {}, {}
    orientation, adobe, jfif = 1, None, False
    while True:
        i = body.find(b"\xff", pos)
        while 0 <= i and i + 1 < len(body) and body[i + 1] == 0xFF:
            i += 1
        if i < 0 or i + 1 >= len(body):
            raise ValueError("truncated JPEG: no EOI marker")
        marker = body[i + 1]
        pos = i + 2
        if marker == 0xD9:                       # EOI
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(body):
            raise ValueError("truncated JPEG marker segment")
        (length,) = struct.unpack(">H", body[pos: pos + 2])
        data = body[pos + 2: pos + length]
        if len(data) != length - 2:
            raise ValueError("truncated JPEG marker segment")
        pos += length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[marker]} JPEG is not supported "
                             f"(baseline only)")
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG with two frames")
            frame = _Frame(data, expected_hw, progressive=marker == 0xC2)
            frames.append(frame)
        elif marker == 0xC4:                     # DHT: built at its scan
            k = 0
            while k < len(data):
                tc_th = data[k]
                counts = data[k + 1: k + 17]
                n = sum(counts)
                if tc_th & 0xEC or n > 256 or k + 17 + n > len(data):
                    raise ValueError("JPEG Huffman table segment is malformed")
                tabs = ac_tabs if tc_th >> 4 else dc_tabs
                tabs[tc_th & 3] = (counts, data[k + 17: k + 17 + n])
                k += 17 + n
        elif marker == 0xDB:                     # DQT
            k = 0
            while k < len(data):
                pq, tq = data[k] >> 4, data[k] & 15
                if pq > 1 or tq > 3 or k + (129 if pq else 65) > len(data):
                    raise ValueError("JPEG quantisation table segment is "
                                     "malformed")
                if pq:
                    vals = np.frombuffer(data[k + 1: k + 129], ">u2")
                    k += 129
                else:
                    vals = np.frombuffer(data[k + 1: k + 65], np.uint8)
                    k += 65
                q = np.zeros(64, np.int64)
                q[np.asarray(_NATURAL[:64])] = vals
                qtabs[tq] = q
        elif marker == 0xDD:                     # DRI
            if len(data) != 2:
                raise ValueError("JPEG restart interval segment is malformed")
            (restart,) = struct.unpack(">H", data)
        elif marker == 0xDA:                     # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            decode = (_decode_progressive_scan if frame.progressive
                      else _decode_scan)
            pos = decode(body, pos, frame, data, dc_tabs, ac_tabs, qtabs,
                         restart)
        elif marker == 0xDC:
            raise ValueError("JPEG with a DNL marker is not supported")
        elif marker == 0xE0 and data.startswith(b"JFIF\x00"):
            jfif = True
        elif (marker == 0xE1 and orientation == 1
              and data.startswith(b"Exif\x00\x00")):
            orientation = exif_orientation(data[6:])
        elif marker == 0xEE and data.startswith(b"Adobe") and len(data) >= 12:
            adobe = data[11]
    if frame is None:
        raise ValueError("JPEG has no frame header")
    if any(c.q is None for c in frame.comps):
        raise ValueError("JPEG component never coded in a scan")
    if frame.progressive:
        for c in frame.comps:
            if any(c.coef_bits):
                raise ValueError(
                    f"unrefined progressive JPEG: component {c.id} has "
                    f"coefficient bits no scan refined (libjpeg smooths "
                    f"such blocks; not supported)")
            c.coef = np.asarray(c.flat, np.int64).reshape(c.rows, c.cols, 64)
            c.flat = None
    frame.colorspace = _colorspace(frame, jfif, adobe)
    return frame, orientation


def _colorspace(frame: _Frame, jfif: bool, adobe: int | None) -> str:
    """libjpeg's ``default_decompress_parms``: the colour space it takes a
    frame to be coded in ("gray", "ycc", "rgb", "cmyk" or "ycck")."""
    n = len(frame.comps)
    if n == 1:
        return "gray"
    if n == 4:
        return "cmyk" if adobe == 0 or adobe is None else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    ids = tuple(c.id for c in frame.comps)
    return "rgb" if ids == (ord("R"), ord("G"), ord("B")) else "ycc"
