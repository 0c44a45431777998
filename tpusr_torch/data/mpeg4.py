"""MPEG-4 Part 2 (Simple Profile) video, decoded as FFmpeg's ``mpeg4``
decoder decodes it on x86 and converted as ``cv2.VideoCapture`` converts it:
the frames that ``cv2.VideoWriter`` writes with the ``mp4v``, ``XVID``,
``DIVX`` or ``FMP4`` fourcc (all four are FFmpeg's ``mpeg4`` encoder).

What it decodes (the tools that FFmpeg's encoder writes by default):

- the VOL (``video_object_layer``) header, from an MP4's ``esds`` or in
  band before the first VOP of an AVI; rectangular, progressive, 8-bit,
  4:2:0, H.263 quantisation, no sprites, no resync markers or data
  partitioning, no quarter-pel, no complexity estimation, no scalability;
- I-VOPs: the intra DC (its own VLC, or the first coefficient of the AC
  VLC above ``intra_dc_vlc_thr``) predicted through the ``dc_scaler``
  tables, AC prediction (the first row or column taken from the predicting
  block), the intra TCOEF VLC with escape modes 1, 2 and 3 and the
  alternate scans;
- P-VOPs: ``not_coded`` MBs, MCBPC/CBPY, intra MBs, one vector per MB
  (median prediction, the ``f_code`` range wrap), unrestricted vectors
  (the reference edge-extended), half-pel luma and chroma prediction in both
  rounding types, the inter TCOEF VLC with H.263 dequantisation;
- FFmpeg's arithmetic where the standard leaves a choice: the
  ``simple_idct`` (``data/idct.py``) put for intra blocks and add for
  inter residuals, int16 coefficients, the escape-3 clip, the H.263
  chroma vector rounding, and the half-pel averages of ``hpeldsp`` on x86,
  whose no-rounding ``x2``/``y2`` versions are MMXEXT approximations
  (``pavgb`` after subtracting 1 with saturation);
- the output cropped to the VOL's size and converted from limited-range
  ``yuv420p`` to BGR by ``data/swscale.py``.

Each other tool raises a ``ValueError`` that names it: B-VOPs, S-VOPs
(sprites/GMC), quarter-pel, interlace, MPEG quantisation matrices,
resync markers and video packets, data partitioning (and RVLC), INTER4V
macroblocks, ``dquant``, DivX packed bitstreams, other shapes, chroma
formats and bit depths, scalability, newpred and reduced resolution.

Each VOP is parsed in one serial pass that collects its blocks'
coefficients and its macroblocks' vectors; the dequantisation, the IDCT,
the prediction and the reconstruction of the whole frame are vectorised.
``Mpeg4Decoder.counts`` counts the tools met.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import numpy as np

from tpusr_torch.data.idct import simple_idct, simple_idct_add, wrap_int16
from tpusr_torch.data.swscale import yuv_to_bgr

VOP, VOL_FIRST, VOL_LAST = 0x1B6, 0x120, 0x12F
USER_DATA, VISUAL_OBJECT = 0x1B2, 0x1B5

# --------------------------------------------------------------- VLC tables
# The H.263/MPEG-4 inter TCOEF codes (code, bits), then the MPEG-4 intra
# codes, each in (last, run, level) order; the last entry is ESCAPE.
_INTER_CODES = [
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9),
    (0x24, 9), (0x21, 10), (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11),
    (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10), (0x21, 11), (0x50, 12),
    (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10),
    (0x53, 12), (0x13, 6), (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10),
    (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10), (0x16, 7), (0x55, 12),
    (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9),
    (0x22, 11), (0x23, 11), (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9),
    (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6), (0xd, 6), (0xc, 6),
    (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8),
    (0x18, 9), (0x17, 9), (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9),
    (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10), (0x5, 10), (0x4, 10),
    (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12), (0x59, 12),
    (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12),
    (0x3, 7)]
# levels per run: last 0 runs 0..26, last 1 runs 0..40
_INTER_LEVELS = ([12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2] + [1] * 16,
                 [3, 2] + [1] * 39)
_INTRA_CODES = [
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6),
    (0x13, 6), (0x12, 6), (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8),
    (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9), (0x21, 10), (0x20, 10),
    (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11),
    (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7),
    (0x1c, 8), (0x20, 9), (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12),
    (0x55, 12), (0xb, 5), (0x15, 7), (0x1e, 9), (0xc, 10), (0x56, 12),
    (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9),
    (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9),
    (0x54, 12), (0x14, 7), (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10),
    (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9), (0x18, 9), (0x7, 10),
    (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10),
    (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10),
    (0xe, 6), (0x4, 10), (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11),
    (0x13, 7), (0x5a, 12), (0x15, 8), (0x5b, 12), (0x14, 8), (0x13, 8),
    (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
    (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12),
    (0x3, 7)]
_INTRA_LEVELS = ([27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1],
                 [8, 3, 2, 2, 2, 2, 2] + [1] * 14)
_ESCAPE = -1


def _tcoef_table(codes, levels):
    """A 12-bit lookup: peeked bits -> (length, last, run, level) or
    (7, ESCAPE, 0, 0); plus ``max_level[last][run]`` and
    ``max_run[last][level]`` for escape modes 1 and 2."""
    syms = [(last, run, lev) for last in (0, 1)
            for run, n in enumerate(levels[last]) for lev in range(1, n + 1)]
    assert len(syms) + 1 == len(codes)
    table = [None] * 4096
    for (code, bits), sym in zip(codes, syms + [None]):
        entry = (bits, _ESCAPE, 0, 0) if sym is None else (bits,) + sym
        lo = code << (12 - bits)
        for k in range(lo, lo + (1 << (12 - bits))):
            assert table[k] is None
            table[k] = entry
    max_level = [list(levels[0]), list(levels[1])]
    max_run = [[0] * 28, [0] * 28]
    for last, run, lev in syms:
        max_run[last][lev] = max(max_run[last][lev], run)
    return table, max_level, max_run


_INTER = _tcoef_table(_INTER_CODES, _INTER_LEVELS)
_INTRA = _tcoef_table(_INTRA_CODES, _INTRA_LEVELS)


def _vlc(entries, bits):
    """A ``bits``-bit lookup from (code, length, value) entries -> (length,
    value), (0, None) where no code matches."""
    table = [(0, None)] * (1 << bits)
    for code, length, value in entries:
        lo = code << (bits - length)
        for k in range(lo, lo + (1 << (bits - length))):
            table[k] = (length, value)
    return table


# MCBPC in I-VOPs: mb type (3 intra, 4 intra+q) * 4 + cbpc; 20 stuffing
_MCBPC_I = _vlc([(1, 1, 12), (1, 3, 13), (2, 3, 14), (3, 3, 15),
                 (1, 4, 16), (1, 6, 17), (2, 6, 18), (3, 6, 19),
                 (1, 9, 20)], 9)
# MCBPC in P-VOPs: type 0 inter, 1 inter+q, 2 inter4v, 3 intra, 4 intra+q,
# 20 stuffing
_MCBPC_P = _vlc([(1, 1, 0), (3, 4, 1), (2, 4, 2), (5, 6, 3),
                 (3, 3, 4), (7, 7, 5), (6, 7, 6), (5, 9, 7),
                 (2, 3, 8), (5, 7, 9), (4, 7, 10), (5, 8, 11),
                 (3, 5, 12), (4, 8, 13), (3, 8, 14), (3, 7, 15),
                 (4, 6, 16), (4, 9, 17), (3, 9, 18), (2, 9, 19),
                 (1, 9, 20)], 9)
_CBPY = _vlc([(c, b, i) for i, (c, b) in enumerate(
    [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
     (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)])], 6)
_MVD = _vlc([(c, b, i) for i, (c, b) in enumerate(
    [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
     (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10),
     (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10),
     (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11),
     (3, 11), (2, 11), (3, 12), (2, 12)])], 12)
_DC_LUM = _vlc([(c, b, i) for i, (c, b) in enumerate(
    [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
     (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)])], 12)
_DC_CHROM = _vlc([(c, b, i) for i, (c, b) in enumerate(
    [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
     (1, 8), (1, 9), (1, 10), (1, 11), (1, 12)])], 12)

_Y_DC_SCALE = [0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46]
_C_DC_SCALE = [0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25]
_DC_THRESHOLD = [99, 13, 15, 17, 19, 21, 23, 0]

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
ALT_HORIZONTAL = [0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
                  13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23,
                  28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
                  38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53,
                  54, 55, 60, 61, 62, 63]
ALT_VERTICAL = [(p % 8) * 8 + p // 8 for p in ALT_HORIZONTAL]


# ------------------------------------------------------------------ headers
class _Bits:
    """An MSB-first bit reader over ``data`` (headers; the VOP loop reads
    the same words inline)."""

    def __init__(self, data: bytes, pos: int = 0):
        b = np.frombuffer(bytes(data) + b"\0" * 8, np.uint8).astype(np.int64)
        self.words = ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8)
                      | b[3:-4]).tolist()
        self.pos = pos
        self.nbits = len(data) * 8

    def peek(self, n: int) -> int:
        p = self.pos
        return (self.words[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if n > 24:
            hi = self.read(n - 16)
            return (hi << 16) | self.read(16)
        v = self.peek(n)
        self.pos += n
        if self.pos > self.nbits:
            raise ValueError("MPEG-4: truncated bitstream")
        return v

    def marker(self, what: str) -> None:
        if not self.read(1):
            raise ValueError(f"MPEG-4: missing marker bit {what}")


def start_codes(data: bytes):
    """(code, offset of the payload after the 4-byte start code) of each
    ``00 00 01 xx`` in ``data``."""
    out, i = [], data.find(b"\0\0\1")
    while 0 <= i <= len(data) - 4:
        out.append((0x100 | data[i + 3], i + 4))
        i = data.find(b"\0\0\1", i + 3)
    return out


@dataclasses.dataclass
class Vol:
    """The fields of a video object layer that decoding reads."""
    width: int
    height: int
    time_increment_bits: int
    time_increment_resolution: int
    encoder: str = ""             # the user data naming the encoder


def _refuse(tool: str):
    raise ValueError(f"MPEG-4: {tool} is not supported (the port decodes "
                     f"the Simple Profile tools that FFmpeg's mpeg4 encoder "
                     f"writes by default)")


def _visual_object(b: _Bits) -> None:
    """The visual object header: video, with no video signal type (which
    would set a colour range or matrix that no fixture checks)."""
    if b.read(1):
        b.read(7)                       # verid, priority
    if b.read(4) != 1:
        _refuse("a visual object other than video")
    if b.read(1):
        _refuse("a video_signal_type (colour range, primaries or matrix)")


def parse_vol(data: bytes, at: int) -> Vol:
    """The VOL whose payload starts at byte ``at`` of ``data``."""
    b = _Bits(data, at * 8)
    b.read(1)                           # random_accessible_vol
    vo_type = b.read(8)
    if vo_type != 1:
        _refuse(f"video_object_type_indication {vo_type} (not Simple)")
    verid = 1
    if b.read(1):
        verid = b.read(4)
        b.read(3)
    if b.read(4) == 15:                 # aspect_ratio_info: extended PAR
        b.read(16)
    if b.read(1):                       # vol_control_parameters
        if b.read(2) != 1:
            _refuse("a chroma format other than 4:2:0")
        if not b.read(1):
            _refuse("low_delay 0 (B-VOPs)")
        if b.read(1):                   # vbv_parameters
            b.read(15); b.marker("in vbv"); b.read(15); b.marker("in vbv")
            b.read(15); b.marker("in vbv"); b.read(3); b.read(11)
            b.marker("in vbv"); b.read(15); b.marker("in vbv")
    shape = b.read(2)
    if shape != 0:
        _refuse(f"video_object_layer_shape {shape} (not rectangular)")
    b.marker("before vop_time_increment_resolution")
    res = b.read(16)
    if res == 0:
        raise ValueError("MPEG-4: vop_time_increment_resolution 0")
    bits = max(1, (res - 1).bit_length())
    b.marker("after vop_time_increment_resolution")
    if b.read(1):                       # fixed_vop_rate
        b.read(bits)
    b.marker("before width")
    width = b.read(13)
    b.marker("before height")
    height = b.read(13)
    b.marker("after height")
    if b.read(1):
        _refuse("interlaced video")
    if not b.read(1):
        _refuse("OBMC (obmc_disable 0)")
    if b.read(1 if verid == 1 else 2):
        _refuse("sprites/GMC (sprite_enable)")
    if b.read(1):
        _refuse("not_8_bit (a quantiser precision or bit depth other "
                "than 5/8)")
    if b.read(1):
        _refuse("MPEG quantisation (quant_type 1, quantisation matrices)")
    if verid != 1 and b.read(1):
        _refuse("quarter-pel motion (quarter_sample)")
    if not b.read(1):
        _refuse("complexity estimation")
    if not b.read(1):
        _refuse("resync markers and video packets (resync_marker_disable "
                "0)")
    if b.read(1):
        _refuse("data partitioning (and RVLC)")
    if verid != 1:
        if b.read(1):
            _refuse("newpred")
        if b.read(1):
            _refuse("reduced resolution VOPs")
    if b.read(1):
        _refuse("scalability")
    if not (0 < width and 0 < height):
        raise ValueError(f"MPEG-4: a {width}x{height} VOL")
    return Vol(width, height, bits, res)


def read_headers(data: bytes, vol: Vol | None = None) -> tuple[Vol | None,
                                                              int | None]:
    """The VOL (with the encoder's user data) found in ``data`` before its
    first VOP, and the VOP's payload offset (None when ``data`` holds no
    VOP). A VOL already known is kept unless ``data`` carries another."""
    encoder = None
    for code, at in start_codes(data):
        if code == VISUAL_OBJECT:
            _visual_object(_Bits(data, at * 8))
        elif VOL_FIRST <= code <= VOL_LAST:
            vol = parse_vol(data, at)
        elif code == USER_DATA:
            end = data.find(b"\0\0\1", at)
            encoder = data[at: end if end >= 0 else len(data)].decode(
                "latin-1")
        elif code == VOP:
            break
        elif not (code in (0x1B0, 0x1B1, 0x1B3) or code < 0x120):
            raise ValueError(f"MPEG-4: unexpected start code {code:#x}")
    else:
        at = None                       # VOS, its end, GOV and VO skipped
    if vol is not None and encoder is not None:
        vol.encoder = encoder
    return vol, at


def check_encoder(vol: Vol, fourcc: str = "") -> None:
    """FFmpeg chooses the IDCT and its bug workarounds from the encoder's
    user data (or, without any, from an XviD/DivX fourcc): the port decodes
    as it does for its own encoder's streams and refuses the others."""
    enc = vol.encoder
    if enc.startswith(("XviD", "DivX", "3ivx")) or (
            not enc and fourcc.upper() in ("XVID", "XVIX", "DIVX", "DX50")):
        _refuse(f"a stream from another encoder ({enc or fourcc}: FFmpeg "
                f"decodes it with that encoder's IDCT and workarounds)")


# -------------------------------------------------------------- the decoder
class Mpeg4Decoder:
    """Decodes the VOPs of one stream in order, keeping the reference
    frame. ``decode(sample)`` -> the (Y, U, V) planes of the frame, padded
    to whole macroblocks, or None for a VOP with ``vop_coded`` 0 (which
    FFmpeg skips: ``cv2.VideoCapture`` reads no frame for it)."""

    def __init__(self, vol: Vol):
        self.vol = vol
        self.mbw, self.mbh = -(-vol.width // 16), -(-vol.height // 16)
        self.ref = None
        self.counts = collections.Counter()

    # -- the bitstream --------------------------------------------------
    def decode(self, data: bytes):
        vol, at = read_headers(data, self.vol)
        if at is None:
            raise ValueError("MPEG-4: a sample with no VOP")
        if vol is not self.vol and (vol.width, vol.height) != (
                self.vol.width, self.vol.height):
            _refuse("a change of frame size")
        self.vol = vol
        if any(code == VOP for code, _ in start_codes(data[at:])):
            _refuse("a DivX packed bitstream (two VOPs in one sample)")
        b = _Bits(data, at * 8)
        kind = b.read(2)
        if kind == 2:
            _refuse("B-VOPs")
        if kind == 3:
            _refuse("S-VOPs (sprites/GMC)")
        while b.read(1):                # modulo_time_base
            pass
        b.marker("before vop_time_increment")
        b.read(self.vol.time_increment_bits)
        b.marker("after vop_time_increment")
        if not b.read(1):               # vop_coded 0: FFmpeg outputs no frame
            self.counts["vop_not_coded"] += 1
            return None
        rounding = b.read(1) if kind == 1 else 0
        thr = _DC_THRESHOLD[b.read(3)]
        qscale = b.read(5)
        if qscale == 0:
            raise ValueError("MPEG-4: vop_quant 0")
        f_code = b.read(3) if kind == 1 else 1
        if f_code == 0:
            raise ValueError("MPEG-4: vop_fcode_forward 0")
        if kind == 1 and self.ref is None:
            raise ValueError("MPEG-4: a P-VOP before any I-VOP")
        self.counts["i_vop" if kind == 0 else f"p_vop_rounding{rounding}"] += 1
        if f_code > 1:
            self.counts["f_code_2_or_more"] += 1
        try:
            mbs = self._parse(b, kind, qscale, thr, f_code)
        except IndexError:                  # read past the padded end
            raise ValueError("MPEG-4: truncated VOP") from None
        self.ref = self._reconstruct(mbs, kind, qscale, rounding)
        return self.ref

    def _parse(self, b: _Bits, kind: int, qscale: int, thr: int,
               f_code: int):
        """The serial pass: per MB (type, mv x, mv y, coded blocks) and the
        blocks' coefficients (natural order; intra blocks quantised with
        their DC and AC predicted, inter blocks dequantised)."""
        W, pos, nbits = b.words, b.pos, b.nbits
        mbw, mbh = self.mbw, self.mbh
        cnt = self.counts
        ytab, ymax_level, ymax_run = _INTRA
        ptab, pmax_level, pmax_run = _INTER
        y_scale, c_scale = _Y_DC_SCALE[qscale], _C_DC_SCALE[qscale]
        use_dc_vlc = qscale < thr
        qmul, qadd = 2 * qscale, (qscale - 1) | 1
        # DC values (scaled) and AC rows/columns of the intra blocks, by
        # block position with a border of 1024 / zeros; luma on an 8x8
        # grid, chroma on the MB grid
        ls = 2 * mbw + 1
        dc = [[1024] * (ls * (2 * mbh + 1)),
              [1024] * ((mbw + 1) * (mbh + 1)),
              [1024] * ((mbw + 1) * (mbh + 1))]
        zero7 = (0,) * 7
        ac = [[zero7] * len(dc[0]) * 2, [zero7] * len(dc[1]) * 2,
              [zero7] * len(dc[2]) * 2]   # [2*i] column, [2*i+1] row
        mvs = [0] * (2 * (mbw + 2) * (mbh + 1))   # border of zeros
        ms = mbw + 2
        lim = 1 << (4 + f_code)           # the vector range wrap
        mb_types, mb_mv, mb_blocks = [], [], []
        coefs = []

        def bad(what):
            raise ValueError(f"MPEG-4: {what} at MB ({mx}, {my})")

        for my in range(mbh):
            for mx in range(mbw):
                if pos > nbits:
                    bad("truncated VOP")
                intra = True
                if kind == 1:
                    while True:
                        if (W[pos >> 3] >> (31 - (pos & 7))) & 1:
                            pos += 1    # not_coded
                            cbpc = -1
                            break
                        pos += 1
                        n, cbpc = _MCBPC_P[(W[pos >> 3] >> (23 - (pos & 7)))
                                           & 511]
                        if not n:
                            bad("an invalid MCBPC")
                        pos += n
                        if cbpc != 20:
                            break
                    if cbpc < 0:
                        cnt["mb_not_coded"] += 1
                        mb_types.append(0)
                        mb_mv.append((0, 0))
                        mb_blocks.append(None)
                        continue
                    mbtype = cbpc >> 2
                    intra = mbtype >= 3
                else:
                    while True:
                        n, cbpc = _MCBPC_I[(W[pos >> 3] >> (23 - (pos & 7)))
                                           & 511]
                        if not n:
                            bad("an invalid MCBPC")
                        pos += n
                        if cbpc != 20:
                            break
                    mbtype = cbpc >> 2
                if mbtype in (1, 4):
                    _refuse("dquant (a per-macroblock quantiser change)")
                if mbtype == 2:
                    _refuse("INTER4V macroblocks (four vectors)")
                cbpc &= 3
                if intra:
                    ac_pred = (W[pos >> 3] >> (31 - (pos & 7))) & 1
                    pos += 1
                n, cbpy = _CBPY[(W[pos >> 3] >> (26 - (pos & 7))) & 63]
                if not n:
                    bad("an invalid CBPY")
                pos += n
                if not intra:
                    cbpy ^= 15
                    # one vector, predicted by the median of left, above,
                    # above right (the first row: left; zeros outside)
                    k = ((my + 1) * ms + mx + 1) * 2
                    if my == 0:
                        px, py = mvs[k - 2], mvs[k - 1]
                    else:
                        a0, a1 = mvs[k - 2], mvs[k - 1]
                        up = k - 2 * ms
                        b0, b1 = mvs[up], mvs[up + 1]
                        c0, c1 = mvs[up + 2], mvs[up + 3]
                        px = a0 + b0 + c0 - min(a0, b0, c0) - max(a0, b0, c0)
                        py = a1 + b1 + c1 - min(a1, b1, c1) - max(a1, b1, c1)
                    vec = []
                    for pred in (px, py):
                        n, code = _MVD[(W[pos >> 3] >> (20 - (pos & 7)))
                                       & 4095]
                        if not n:
                            bad("an invalid motion vector code")
                        pos += n
                        if code:
                            sign = (W[pos >> 3] >> (31 - (pos & 7))) & 1
                            pos += 1
                            val = code
                            if f_code > 1:
                                s = f_code - 1
                                val = (((val - 1) << s)
                                       | ((W[pos >> 3] >> (32 - (pos & 7) - s))
                                          & ((1 << s) - 1))) + 1
                                pos += s
                            val = pred - val if sign else pred + val
                            val = ((val + lim) % (2 * lim)) - lim
                        else:
                            val = pred
                        vec.append(val)
                    mvs[k], mvs[k + 1] = vec
                    mb_types.append(1)
                    mb_mv.append(tuple(vec))
                    cnt["mb_inter"] += 1
                else:
                    mb_types.append(2)
                    mb_mv.append((0, 0))
                    cnt["mb_intra_p" if kind == 1 else "mb_intra_i"] += 1
                    if ac_pred:
                        cnt["ac_pred"] += 1
                cbp = (cbpy << 2) | cbpc
                blocks = []
                for n_blk in range(6):
                    coded = (cbp >> (5 - n_blk)) & 1
                    if not intra:
                        if not coded:
                            blocks.append(-1)
                            continue
                        blk = [0] * 64
                        i = -1
                        tab, max_level, max_run = ptab, pmax_level, pmax_run
                    else:
                        blk = [0] * 64
                        # the DC predictor's neighbours: A left, B above
                        # left, C above
                        if n_blk < 4:
                            plane, st = 0, ls
                            bx = 2 * mx + (n_blk & 1)
                            by = 2 * my + (n_blk >> 1)
                            scale = y_scale
                        else:
                            plane, st = n_blk - 3, mbw + 1
                            bx, by, scale = mx, my, c_scale
                        d = dc[plane]
                        at = (by + 1) * st + bx + 1
                        a, bb, c = d[at - 1], d[at - 1 - st], d[at - st]
                        top = abs(a - bb) < abs(bb - c)
                        pred = ((c if top else a) + (scale >> 1)) // scale
                        i = -1
                        if use_dc_vlc:
                            n, size = (_DC_LUM if n_blk < 4 else _DC_CHROM)[
                                (W[pos >> 3] >> (20 - (pos & 7))) & 4095]
                            if not n:
                                bad("an invalid DC size code")
                            pos += n
                            level = 0
                            if size:
                                v = (W[pos >> 3] >> (32 - (pos & 7) - size)) \
                                    & ((1 << size) - 1)
                                pos += size
                                level = v if v >> (size - 1) else \
                                    v - (1 << size) + 1
                                if size > 8:     # a marker bit
                                    if not (W[pos >> 3] >> (31 - (pos & 7))
                                            ) & 1:
                                        bad("a missing DC marker bit")
                                    pos += 1
                            blk[0] = level
                            i = 0
                        else:
                            cnt["dc_in_ac"] += 1
                        tab, max_level, max_run = ytab, ymax_level, ymax_run
                    # AC prediction from above reads along rows first
                    scan = ZIGZAG if not (intra and ac_pred) else (
                        ALT_HORIZONTAL if top else ALT_VERTICAL)
                    if coded:
                        while True:
                            e = tab[(W[pos >> 3] >> (20 - (pos & 7))) & 4095]
                            if e is None:
                                bad("an invalid TCOEF code")
                            n, last, run, level = e
                            pos += n
                            if last == _ESCAPE:
                                w = (W[pos >> 3] >> (30 - (pos & 7))) & 3
                                if w < 2:          # escape 1: level + LMAX
                                    pos += 1
                                    e = tab[(W[pos >> 3] >> (20 - (pos & 7)))
                                            & 4095]
                                    if e is None or e[1] == _ESCAPE:
                                        bad("an invalid escaped TCOEF code")
                                    n, last, run, level = e
                                    pos += n
                                    level += max_level[last][run]
                                    cnt["escape1"] += 1
                                elif w == 2:       # escape 2: run + RMAX + 1
                                    pos += 2
                                    e = tab[(W[pos >> 3] >> (20 - (pos & 7)))
                                            & 4095]
                                    if e is None or e[1] == _ESCAPE:
                                        bad("an invalid escaped TCOEF code")
                                    n, last, run, level = e
                                    pos += n
                                    run += max_run[last][level] + 1
                                    cnt["escape2"] += 1
                                else:              # escape 3: fixed length
                                    pos += 2
                                    v = (W[pos >> 3] >> (11 - (pos & 7))) \
                                        & 0x1FFFFF
                                    pos += 21
                                    last, run = v >> 20, (v >> 14) & 63
                                    if not (v >> 13) & 1 or not v & 1:
                                        bad("a missing escape marker bit")
                                    level = (v >> 1) & 0xFFF
                                    if level >= 2048:
                                        level -= 4096
                                    i += run + 1
                                    if not intra:
                                        level = (level * qmul + qadd
                                                 if level > 0 else
                                                 level * qmul - qadd)
                                    level = min(2047, max(-2048, level))
                                    cnt["escape3"] += 1
                                    if i > 63:
                                        bad("a run past the block's end")
                                    blk[scan[i]] = level
                                    if last:
                                        break
                                    continue
                            sign = (W[pos >> 3] >> (31 - (pos & 7))) & 1
                            pos += 1
                            if not intra:
                                level = level * qmul + qadd
                            i += run + 1
                            if i > 63:
                                bad("a run past the block's end")
                            blk[scan[i]] = -level if sign else level
                            if last:
                                break
                    if intra:
                        # DC: the quantised level plus the prediction; the
                        # predictor keeps level * scale clipped to 0..2047
                        dc_level = blk[0] + pred
                        blk[0] = dc_level
                        v = dc_level * scale
                        d[at] = 0 if v < 0 else (2047 if v > 2047 else v)
                        acp = ac[plane]
                        if ac_pred:
                            if top:
                                row = acp[2 * (at - st) + 1]
                                for k in range(1, 8):
                                    blk[k] += row[k - 1]
                            else:
                                col = acp[2 * (at - 1)]
                                for k in range(1, 8):
                                    blk[8 * k] += col[k - 1]
                        acp[2 * at] = tuple(blk[8:64:8])
                        acp[2 * at + 1] = tuple(blk[1:8])
                    blocks.append(len(coefs) >> 6)
                    coefs.extend(blk)
                mb_blocks.append(blocks)
        if pos > nbits:
            raise ValueError("MPEG-4: truncated VOP")
        return mb_types, mb_mv, mb_blocks, coefs

    # -- reconstruction --------------------------------------------------
    def _reconstruct(self, mbs, kind: int, qscale: int, rounding: int):
        mb_types, mb_mv, mb_blocks, coefs = mbs
        mbw, mbh = self.mbw, self.mbh
        nmb = mbw * mbh
        types = np.asarray(mb_types, np.int64)
        coef = np.array(coefs, np.int64).reshape(-1, 64)
        # which MB and block each coefficient block belongs to
        owner = np.zeros(len(coef), np.int64)
        which = np.zeros(len(coef), np.int64)
        for m, blocks in enumerate(mb_blocks):
            if blocks:
                for n_blk, at in enumerate(blocks):
                    if at >= 0:
                        owner[at], which[at] = m, n_blk
        intra = types[owner] == 2
        # intra dequantisation (dct_unquantize_h263_intra), int16
        ci = coef[intra]
        if len(ci):
            q2, qadd = 2 * qscale, (qscale - 1) | 1
            ac = np.where(ci > 0, ci * q2 + qadd,
                          np.where(ci < 0, ci * q2 - qadd, 0))
            ac[:, 0] = ci[:, 0] * np.where(which[intra] < 4,
                                           _Y_DC_SCALE[qscale],
                                           _C_DC_SCALE[qscale])
            coef[intra] = wrap_int16(ac)
        Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
        U = np.zeros((mbh * 8, mbw * 8), np.uint8)
        V = np.zeros((mbh * 8, mbw * 8), np.uint8)
        if kind == 1:
            mv = np.asarray(mb_mv, np.int64).reshape(nmb, 2)
            self._predict(mv, rounding, Y, U, V)
        # the blocks, placed
        mbx, mby = owner % mbw, owner // mbw
        blocks = coef.reshape(-1, 8, 8)
        out = np.empty((len(coef), 8, 8), np.uint8)
        if intra.any():
            out[intra] = simple_idct(blocks[intra])
        inter = ~intra
        if inter.any():
            pred = self._gather(Y, U, V, mbx[inter], mby[inter],
                                which[inter])
            out[inter] = simple_idct_add(blocks[inter], pred)
        self._scatter(out, Y, U, V, mbx, mby, which)
        return Y, U, V

    @staticmethod
    def _block_origin(mbx, mby, which):
        luma = which < 4
        y0 = np.where(luma, mby * 16 + (which >> 1) * 8, mby * 8)
        x0 = np.where(luma, mbx * 16 + (which & 1) * 8, mbx * 8)
        return y0, x0

    def _gather(self, Y, U, V, mbx, mby, which):
        y0, x0 = self._block_origin(mbx, mby, which)
        out = np.empty((len(which), 8, 8), np.uint8)
        r = np.arange(8)
        for plane, sel in ((Y, which < 4), (U, which == 4), (V, which == 5)):
            if sel.any():
                out[sel] = plane[(y0[sel][:, None] + r)[:, :, None],
                                 (x0[sel][:, None] + r)[:, None, :]]
        return out

    def _scatter(self, out, Y, U, V, mbx, mby, which):
        y0, x0 = self._block_origin(mbx, mby, which)
        r = np.arange(8)
        for plane, sel in ((Y, which < 4), (U, which == 4), (V, which == 5)):
            if sel.any():
                plane[(y0[sel][:, None] + r)[:, :, None],
                      (x0[sel][:, None] + r)[:, None, :]] = out[sel]

    def _predict(self, mv, rounding, Y, U, V):
        """Every MB's motion-compensated prediction from the reference: a
        copy where the vector is zero (not-coded and intra MBs among them;
        intra ones are overwritten), else the half-pel average. The
        reference is edge-extended beyond its whole MBs (FFmpeg's
        ``h_edge_pos``/``v_edge_pos``), not beyond the VOL's size."""
        mbw, mbh = self.mbw, self.mbh
        moved = np.flatnonzero(mv.any(axis=1))
        mx, my = mv[moved, 0], mv[moved, 1]
        mbx, mby = moved % mbw, moved // mbw
        for k, (ref, dst) in enumerate(zip(self.ref, (Y, U, V))):
            dst[:] = ref
            if not len(moved):
                continue
            if k == 0:              # luma: (mv >> 1) with half-pel flags
                y0, x0 = mby * 16 + (my >> 1), mbx * 16 + (mx >> 1)
                hy, hx, size = my & 1, mx & 1, 16
                self._count_vectors(y0, x0, hy, hx, rounding, ref.shape)
            else:                   # chroma: H.263's rounding of mv / 2
                y0 = (mby * 16 + (my >> 1)) >> 1
                x0 = (mbx * 16 + (mx >> 1)) >> 1
                hy, hx = (my & 1) | ((my & 2) >> 1), (mx & 1) | ((mx & 2) >> 1)
                size = 8
            pred = _hpel(ref, y0, x0, hy, hx, size, rounding, self.counts)
            dst.reshape(mbh, size, mbw, size).transpose(0, 2, 1, 3)[
                mby, mbx] = pred

    def _count_vectors(self, y0, x0, hy, hx, rounding, shape):
        eh, ew = shape
        self.counts["mv_outside"] += int(
            ((y0 < 0) | (x0 < 0) | (y0 + 16 + hy > eh)
             | (x0 + 16 + hx > ew)).sum())
        for name, fy, fx in (("x", 0, 1), ("y", 1, 0), ("xy", 1, 1)):
            self.counts[f"hpel_{name}_rounding{rounding}"] += int(
                ((hy == fy) & (hx == fx)).sum())


def _hpel(ref, y0, x0, hy, hx, size, rounding, counts):
    """Blocks of ``size`` at integer origins (y0, x0) plus half-pel flags,
    read from ``ref`` extended beyond its edges, averaged as FFmpeg's
    ``hpeldsp`` on x86 (``put_pixels`` with rounding, or
    ``put_no_rnd_pixels``)."""
    eh, ew = ref.shape
    r = np.arange(size + 1)
    ys = np.clip(y0[:, None] + r, 0, eh - 1)
    xs = np.clip(x0[:, None] + r, 0, ew - 1)
    blk = ref[ys[:, :, None], xs[:, None, :]].astype(np.int16)
    out = np.empty((len(y0), size, size), np.uint8)
    for fy in (0, 1):
        for fx in (0, 1):
            sel = (hy == fy) & (hx == fx)
            if not sel.any():
                continue
            g = blk[sel]
            a = g[:, :size, :size]
            if fx and fy:
                v = (a + g[:, :size, 1:] + g[:, 1:, :size] + g[:, 1:, 1:]
                     + 2 - rounding) >> 2
            elif fx or fy:
                b = g[:, :size, 1:] if fx else g[:, 1:, :size]
                v = (a + b + 1 - rounding) >> 1
                if rounding and size == 8:
                    # put_no_rnd_pixels8_x2/_y2_mmxext (chroma): pavgb
                    # after a saturating -1 on the left sample, or on the
                    # block's odd source rows; the 16-wide luma versions
                    # are exact
                    if fx:
                        lo, hi = np.maximum(a - 1, 0), b
                    else:
                        odd = (np.arange(size) % 2 == 1)[None, :, None]
                        lo = np.where(odd, np.maximum(a - 1, 0), a)
                        hi = np.where(odd, b, np.maximum(b - 1, 0))
                    exact, v = v, (lo + hi + 1) >> 1
                    counts["hpel_chroma_approx_differs"] += int(
                        (v != exact).sum())
            else:
                v = a
            out[sel] = v
    return out


def to_bgr(planes, vol: Vol) -> np.ndarray:
    """Decoded planes -> (h, w, 3) uint8 BGR cropped to the VOL's size, as
    swscale converts ``yuv420p`` for ``cv2.VideoCapture``."""
    y, u, v = planes
    h, w = vol.height, vol.width
    return yuv_to_bgr(y[:h, :w], u[:(h + 1) // 2, :(w + 1) // 2],
                      v[:(h + 1) // 2, :(w + 1) // 2], 2, full_range=False)


def _vop_head(data: bytes, at: int, vol: Vol) -> tuple[int, bool]:
    """(vop_coding_type, vop_coded) of the VOP whose payload starts at
    byte ``at``."""
    b = _Bits(data[at: at + 16], 0)
    kind = b.read(2)
    while b.read(1):
        pass
    b.read(1 + vol.time_increment_bits + 1)
    return kind, bool(b.read(1))


class Mpeg4Video:
    """An MPEG-4 Part 2 stream: its VOL, the rate ``CAP_PROP_FPS`` gives,
    its fourcc and its samples (one VOP each, in decode order), read as
    ``cv2.VideoCapture`` reads them: one frame per coded VOP."""

    def __init__(self, vol: Vol, fps: float, samples: list, fourcc: str):
        check_encoder(vol, fourcc)
        self.vol, self.fps, self.fourcc = vol, fps, fourcc
        self.samples = samples
        self.coded, self.intra = [], []
        for i, s in enumerate(samples):
            vol, at = read_headers(s, vol)
            if at is None:
                raise ValueError(f"MPEG-4: sample {i} holds no VOP")
            kind, coded = _vop_head(s, at, vol)
            if coded:
                self.coded.append(i)
                if kind == 0:
                    self.intra.append(i)
        self.counts = collections.Counter()

    @classmethod
    def from_config(cls, config: bytes, fps: float, samples: list,
                    fourcc: str, path: str) -> "Mpeg4Video":
        """A stream whose VOL is in ``config`` (an MP4's esds)."""
        vol, _ = read_headers(config)
        if vol is None:
            raise ValueError(f"{path}: the decoder config holds no VOL")
        return cls(vol, fps, samples, fourcc)

    @classmethod
    def from_samples(cls, fps: float, samples: list, fourcc: str,
                     path: str) -> "Mpeg4Video":
        """A stream whose VOL is in band, before its first VOP (an AVI)."""
        vol = read_headers(samples[0])[0] if samples else None
        if vol is None:
            raise ValueError(f"{path}: no VOL before the first VOP")
        return cls(vol, fps, samples, fourcc)

    @property
    def width(self) -> int:
        return self.vol.width

    @property
    def height(self) -> int:
        return self.vol.height

    def __len__(self) -> int:
        return len(self.coded)

    def _decoded(self, start: int, stop: int):
        """(sample index, planes, VOL) of the samples start..stop-1,
        decoded in order by a new decoder."""
        dec = Mpeg4Decoder(self.vol)
        try:
            for i in range(start, stop):
                planes = dec.decode(self.samples[i])
                if planes is not None:
                    yield i, planes, dec.vol
        finally:
            self.counts.update(dec.counts)

    def frame(self, i: int) -> np.ndarray:
        """Frame ``i`` as (h, w, 3) uint8 BGR, as ``VideoCapture.read``
        gives it: decoded in order from the last I-VOP before it."""
        s = self.coded[i]
        k = bisect.bisect_right(self.intra, s) - 1
        if k < 0:
            raise ValueError("MPEG-4: no I-VOP before the frame")
        for _, planes, vol in self._decoded(self.intra[k], s + 1):
            pass
        return to_bgr(planes, vol)

    def frames(self):
        """The frames in order, each a zero-argument callable that converts
        it to BGR: every VOP is decoded (the next ones predict from it), only
        the frames asked for are converted."""
        for _, planes, vol in self._decoded(0, len(self.samples)):
            yield lambda p=planes, v=vol: to_bgr(p, v)
