"""VP8 video (RFC 6386), decoded as FFmpeg's ``vp8`` decoder decodes it
for ``cv2.VideoCapture`` and converted as OpenCV converts it: the frames
that ``cv2.VideoWriter`` writes with the ``VP80`` fourcc into WebM
(libvpx), key frames and interframes.

``pipeline/vp8.py`` (the WebP key-frame decoder) gives the boolean decoder,
the token reader, the inverse WHT and DCT, the intra predictors and the
loop filter; this module adds the state that a stream carries from frame
to frame and what interframes use:

- the header: golden and altref refresh, ``copy_buffer_to_gf``/``_arf``
  (from the buffers before this frame's updates, as FFmpeg swaps them),
  the sign biases, ``refresh_entropy_probs`` 0 (the probabilities saved
  and restored after the frame), ``refresh_last``, loop-filter deltas
  that persist until updated, segment quantiser and filter values that
  persist until updated, and a segment map kept from the frame before
  when it is not updated;
- probabilities that persist: coefficients, the 16x16 and chroma mode
  probabilities and the motion vector probabilities, each with its
  updates; ``prob_intra``, ``prob_last`` and ``prob_gf``;
- per macroblock: the reference frame, the near-MV search over the
  macroblocks above, left and above-left (sign-bias inversion, the
  counts' contexts, clamping), ``NEARESTMV``, ``NEARMV``, ``ZEROMV``,
  ``NEWMV`` (short tree and long bits), ``SPLITMV`` with 16x8, 8x16, 8x8
  and 4x4 partitions and ``LEFT4X4``, ``ABOVE4X4``, ``ZERO4X4`` and
  ``NEW4X4`` sub-MVs; intra macroblocks with the interframe mode trees,
  ``B_PRED`` with its fixed sub-mode probabilities;
- prediction: each 4x4 block from its reference with the six-tap filters
  (version 0) or the bilinear ones (versions 1-3), both passes in integers
  with FFmpeg's rounding and the intermediate clamped, chroma MVs as the
  rounded mean of the four luma MVs (whole pixels at version 3), the
  reference planes extended by edge replication from the macroblock-
  aligned size; then the residual, and the intra macroblocks in raster
  order from the unfiltered frame;
- the loop filter at each macroblock's level (segment, reference and mode
  deltas, the interframe ``hev`` thresholds), inner edges skipped for a
  macroblock without coefficients that is neither ``B_PRED`` nor
  ``SPLITMV`` (FFmpeg's rule, which counts the Y2 block's tokens);
- a frame with ``show_frame`` 0 is decoded into the references and not
  returned (FFmpeg gives no picture for it); the frames returned are
  cropped to the frame size and converted from limited-range ``yuv420p``
  by ``data/swscale.py``.

Prediction, transforms and the filters run as numpy work over every block
of the frame at once (the loop filter by anti-diagonals of macroblocks);
the bitstream is read in Python. ``Vp8Decoder.counts`` counts the tools
met; ``TOOLS`` lists every one the decoder implements.

A key frame whose clamping-type bit is set comes out of FFmpeg as a
full-range picture, which swscale converts with the JPEG coefficients; the
interframes after it do not. The horizontal and vertical scaling bits are
ignored, as FFmpeg ignores them.

Refused by name, with ``ValueError``: a profile above 3, a stream that
does not start with a key frame, a change of frame size, an odd frame
height (swscale converts it on another path), a segment map kept when none
was sent or across a frame without segmentation, a truncated partition,
and a partition size past the frame.
"""

from __future__ import annotations

import collections

import numpy as np

from tpusr_torch.data.swscale import yuv_to_bgr
from tpusr_torch.pipeline import vp8 as kf
from tpusr_torch.pipeline.vp8_tables import COEF_PROBS

INTRA, LAST, GOLDEN, ALTREF = range(4)
REF_NAMES = ("intra", "last", "golden", "altref")
ZEROMV, NEARESTMV, NEARMV, NEWMV, SPLITMV = range(5)
MV_NAMES = ("zero", "nearest", "near", "new", "split")
# the loop filter's mode delta of each interframe mode (FFmpeg's
# lf_delta.mode: 1 ZEROMV, 2 the other single vectors, 3 SPLITMV)
_MODE_DELTA = (1, 2, 2, 2, 3)

YMODE_PROBS = (112, 86, 140, 37)
UV_PROBS = (162, 101, 204)
BMODE_PROBS = (120, 90, 79, 133, 87, 85, 80, 111, 151)
MV_PROBS = ((162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75,
             145, 178, 206, 239, 254, 254),
            (164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74,
             148, 180, 203, 236, 254, 254))
MV_UPDATE_PROBS = ((237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254,
                    254, 254, 254, 250, 250, 252, 254, 254),
                   (231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254,
                    254, 254, 254, 251, 251, 254, 254, 254))
MODE_CONTEXTS = ((7, 1, 1, 143), (14, 18, 14, 107), (135, 64, 57, 68),
                 (60, 56, 128, 65), (159, 134, 128, 34), (234, 188, 128, 28))
SUBMV_PROBS = ((147, 136, 18), (106, 145, 1), (179, 121, 1), (223, 1, 34),
               (208, 1, 1))
# the partitions 16x8, 8x16, 8x8 and 4x4: each 4x4 block's partition, and
# the first block of each partition
SPLITS = ((0,) * 8 + (1,) * 8, (0, 0, 1, 1) * 4,
          (0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3), tuple(range(16)))
SPLIT_NAMES = ("16x8", "8x16", "8x8", "4x4")
FIRST_BLOCK = tuple(tuple(sorted({s.index(p) for p in s})) for s in SPLITS)
SIXTAP = ((0, 0, 128, 0, 0, 0), (0, -6, 123, 12, -1, 0),
          (2, -11, 108, 36, -8, 1), (0, -9, 93, 50, -6, 0),
          (3, -16, 77, 77, -16, 3), (0, -6, 50, 93, -9, 0),
          (1, -8, 36, 108, -11, 2), (0, -1, 12, 123, -6, 0))
BILINEAR = tuple((0, 0, 128 - 16 * m, 16 * m, 0, 0) for m in range(8))
_FILTERS = np.array([SIXTAP, BILINEAR], np.int64)      # [bilinear][eighth]
_MARGIN = 64                    # MV clamp margin: 16 pixels in quarter-pels
# the inter 16x16 mode tree's leaves in pipeline/vp8's mode numbers
_Y_DC, _Y_V, _Y_H, _Y_TM = kf.DC, kf.VE, kf.HE, kf.TM

TOOLS = (
    "key_frame", "inter_frame", "hidden_frame", "full_range_key",
    "profile_0", "profile_1", "profile_2", "profile_3", "scaling_bits",
    "filter_none", "filter_simple",
    "filter_normal", "partitions_2+", "segments", "segment_map_update",
    "segment_map_kept", "segment_data_kept", "lf_delta", "lf_delta_update",
    "coef_prob_update", "no_skip_flags", "refresh_golden", "refresh_altref",
    "copy_gf_last", "copy_gf_altref", "copy_arf_last", "copy_arf_golden",
    "sign_bias_golden", "sign_bias_altref", "no_refresh_entropy",
    "no_refresh_last", "ymode_prob_update", "uv_prob_update",
    "mv_prob_update", "ref_last", "ref_golden", "ref_altref",
    "sign_bias_inversion", "mode_zero", "mode_nearest", "mode_near",
    "mode_new", "mode_split", "split_16x8", "split_8x16", "split_8x8",
    "split_4x4", "sub_left", "sub_above", "sub_zero", "sub_new",
    "mv_long", "mv_clamped", "mv_outside", "intra_i16_inter",
    "intra_bpred_inter", "inner_edges_skipped")


def _mv_component(bit, p) -> int:
    """One MV component (quarter pixels) with its probabilities ``p``."""
    if bit(p[0]):
        x = 0
        for i in range(3):
            x += bit(p[9 + i]) << i
        for i in range(9, 3, -1):
            x += bit(p[9 + i]) << i
        if not x & 0xFFF0 or bit(p[12]):
            x += 8
    else:
        b0 = bit(p[2])
        b1 = bit(p[6] if b0 else p[3])
        x = 4 * b0 + 2 * b1 + bit(p[(7 if b0 else 4) + b1])
    return -x if x and bit(p[1]) else x


def _bmode(bit, prob) -> int:
    """A ``B_PRED`` sub-mode through pipeline/vp8's tree."""
    j = kf._BMODE_TREE[bit(prob[0])]
    while j > 0:
        j = kf._BMODE_TREE[2 * j + bit(prob[j])]
    return -j


def near_mvs(mbs, mbx, mby, mbw, ref, sign_bias):
    """The near-MV search of a macroblock with reference ``ref`` over the
    macroblocks above, left and above-left (FFmpeg's vp8_decode_mvs):
    (the counts that select the mode probabilities, the zero, nearest,
    near and third vectors, how many were sign-inverted), with the counts
    and vectors already merged and swapped as the bits after the first
    one read them."""
    near = [(0, 0)] * 4
    c = [0, 0, 0, 0]
    idx = inverted = 0
    for n, (dx, dy) in enumerate(((0, -1), (-1, 0), (-1, -1))):
        x, y = mbx + dx, mby + dy
        if x < 0 or y < 0:                  # outside the frame: intra
            continue
        j = y * mbw + x
        r = mbs.ref[j]
        if r == INTRA:
            continue
        mv = mbs.mv[j]
        weight = 1 if n == 2 else 2
        if mv != (0, 0):
            if sign_bias[r] != sign_bias[ref]:
                mv = (-mv[0], -mv[1])
                inverted += 1
            if n == 0 or mv != near[idx]:
                idx += 1
                near[idx] = mv
            c[idx] += weight
        else:
            c[0] += weight
    if c[3] and near[1] == near[3]:
        c[1] += 1
    if c[2] > c[1]:
        c[1], c[2] = c[2], c[1]
        near[1], near[2] = near[2], near[1]
    return c, near, inverted


def mv_bounds(mbx, mby, mbw, mbh):
    """(lowest y, highest y, lowest x, highest x) of a clamped vector."""
    return (-_MARGIN - 64 * mby, 64 * (mbh - mby), -_MARGIN - 64 * mbx,
            64 * (mbw - mbx))


def clamp_mv(mv, bounds):
    lo_y, hi_y, lo_x, hi_x = bounds
    return min(max(mv[0], lo_y), hi_y), min(max(mv[1], lo_x), hi_x)


def split_context(mbs, mbx, mby, mbw) -> int:
    """The SPLITMV probability's context: the split macroblocks left and
    above (2 each) and above-left (1)."""
    return sum(w for (dx, dy), w in (((-1, 0), 2), ((0, -1), 2),
                                     ((-1, -1), 1))
               if mbx + dx >= 0 and mby + dy >= 0 and
               mbs.mode[(mby + dy) * mbw + mbx + dx] == SPLITMV)


def submv_probs(lmv, amv):
    """A sub-MV's probabilities from the vectors left and above it."""
    if lmv == amv:
        return SUBMV_PROBS[4 if lmv == (0, 0) else 3]
    if amv == (0, 0):
        return SUBMV_PROBS[2]
    return SUBMV_PROBS[1 if lmv == (0, 0) else 0]


class Macroblocks:
    """One frame's macroblock modes, in raster order."""

    def __init__(self, n: int):
        self.seg = [0] * n
        self.skip = [0] * n
        self.ref = [INTRA] * n
        self.ymode = [0] * n            # intra: 16x16 mode or -1 (B_PRED)
        self.bmodes = [None] * n
        self.uvmode = [0] * n
        self.mode = [None] * n          # inter: ZEROMV ... SPLITMV
        self.mv = [(0, 0)] * n          # (y, x) quarter pixels
        self.bmv = [None] * n           # 16 block MVs of an inter MB


class _Header:
    """The parts of a frame header that FFmpeg keeps from frame to frame,
    and this frame's own fields."""

    def __init__(self):
        self.segments = 0
        self.update_map = 0
        self.absolute = 0
        self.seg_q = [0] * 4
        self.seg_lf = [0] * 4
        self.seg_probs = [255] * 3
        self.use_lf_delta = 0
        self.ref_delta = [0] * 4
        self.mode_delta = [0] * 4

    read_quant = kf._Header.read_quant


class Vp8Decoder:
    """Decodes the frames of one VP8 stream in order, keeping the three
    reference frames and the probabilities. ``decode(frame)`` -> the
    (Y, U, V) planes of the macroblock-aligned frame, or None for a frame
    with ``show_frame`` 0."""

    def __init__(self):
        self.width = self.height = 0
        self.mbw = self.mbh = 0
        self.refs = [None] * 4          # LAST, GOLDEN, ALTREF: (Y, UV)
        self.hdr = _Header()
        self.seg_map = None             # the last frame's map, if valid
        self.counts = collections.Counter()
        self.full_range = 0
        self._reset_probs()

    def _reset_probs(self):
        self.coef = bytearray(COEF_PROBS)
        self.ymode_probs = list(YMODE_PROBS)
        self.uv_probs = list(UV_PROBS)
        self.mv_probs = [list(p) for p in MV_PROBS]

    def _probs(self):
        return (bytearray(self.coef), list(self.ymode_probs),
                list(self.uv_probs), [list(p) for p in self.mv_probs])

    # -- the frame header --------------------------------------------------
    def decode(self, data: bytes):
        if len(data) < 3:
            raise ValueError("VP8: a frame shorter than its 3-byte tag")
        tag = data[0] | data[1] << 8 | data[2] << 16
        key = not tag & 1
        profile = (tag >> 1) & 7
        show = (tag >> 4) & 1
        first = tag >> 5
        cnt = self.counts
        if profile > 3:
            raise ValueError(f"VP8: profile {profile} is not 0-3")
        pos = 3
        if key:
            if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
                raise ValueError("VP8: a key frame without its start code")
            w = (data[6] | data[7] << 8) & 0x3FFF
            h = (data[8] | data[9] << 8) & 0x3FFF
            if data[7] >> 6 or data[9] >> 6:
                cnt["scaling_bits"] += 1    # FFmpeg ignores the upscaling
            if not w or not h:
                raise ValueError("VP8: a frame of zero width or height")
            if self.width and (w, h) != (self.width, self.height):
                raise ValueError(f"VP8: a change of frame size "
                                 f"({self.width}x{self.height} to {w}x{h})")
            self.width, self.height = w, h
            self.mbw, self.mbh = (w + 15) >> 4, (h + 15) >> 4
            pos = 10
        elif self.refs[LAST] is None:
            raise ValueError("VP8: an interframe before any key frame")
        else:
            self.full_range = 0
        if first > len(data) - pos:
            raise ValueError("VP8: the first partition runs past the frame")
        br = kf.BoolDecoder(data, pos, pos + first)
        if key:                 # FFmpeg zeroes segmentation and the deltas
            self.hdr = _Header()
            self._reset_probs()
            br.bit(128)                     # colour space
            self.full_range = br.bit(128)   # clamping type
            if self.full_range:     # FFmpeg: a full-range picture
                cnt["full_range_key"] += 1
        cnt["key_frame" if key else "inter_frame"] += 1
        cnt[f"profile_{profile}"] += 1
        if not show:
            cnt["hidden_frame"] += 1
        hdr = self.hdr
        self._segmentation(br, key)
        simple, level, sharpness = br.bit(128), br.literal(6), br.literal(3)
        filter_type = 0 if level == 0 else 1 if simple else 2
        cnt[("filter_none", "filter_simple", "filter_normal")[filter_type]] \
            += 1
        hdr.use_lf_delta = br.bit(128)
        if hdr.use_lf_delta:
            cnt["lf_delta"] += 1
            if br.bit(128):
                cnt["lf_delta_update"] += 1
                for deltas in (hdr.ref_delta, hdr.mode_delta):
                    for i in range(4):
                        if br.bit(128):
                            deltas[i] = br.signed(6)
        parts = self._partitions(br, data, pos + first)
        quant = hdr.read_quant(br)
        update = [INTRA] * 4            # the buffer each ref becomes (INTRA:
        sign_bias = [0] * 4             # this frame)
        if not key:
            refresh_g, refresh_a = br.bit(128), br.bit(128)
            for ref, refresh, other in ((GOLDEN, refresh_g, ALTREF),
                                        (ALTREF, refresh_a, GOLDEN)):
                name = "gf" if ref == GOLDEN else "arf"
                if refresh:
                    cnt[f"refresh_{REF_NAMES[ref]}"] += 1
                    continue
                copy = br.literal(2)
                update[ref] = (ref, LAST, other, ref)[copy]
                if copy in (1, 2):
                    cnt[f"copy_{name}_{REF_NAMES[update[ref]]}"] += 1
            sign_bias[GOLDEN], sign_bias[ALTREF] = br.bit(128), br.bit(128)
            for ref in (GOLDEN, ALTREF):
                if sign_bias[ref]:
                    cnt[f"sign_bias_{REF_NAMES[ref]}"] += 1
        saved = None
        if not br.bit(128):                 # refresh_entropy_probs
            saved = self._probs()
            cnt["no_refresh_entropy"] += 1
        update_last = key or br.bit(128)
        if not update_last:
            cnt["no_refresh_last"] += 1
        if kf._update_probs(br, self.coef):
            cnt["coef_prob_update"] += 1
        skip_prob = br.literal(8) if br.bit(128) else None
        if skip_prob is None:
            cnt["no_skip_flags"] += 1
        if key:
            mbs = self._key_modes(br, skip_prob)
        else:
            probs = br.literal(8), br.literal(8), br.literal(8)
            self._mode_prob_updates(br)
            mbs = self._inter_modes(br, skip_prob, probs, sign_bias)
        if br.eof:
            raise ValueError("VP8: the first partition ends before its "
                             "modes")
        planes = self._reconstruct(mbs, parts, quant, key, profile,
                                   filter_type, level, sharpness)
        self._update_refs(planes, key, update, update_last)
        if saved is not None:
            self.coef, self.ymode_probs, self.uv_probs, self.mv_probs = saved
        return (planes[0], planes[1][0], planes[1][1]) if show else None

    def _segmentation(self, br, key):
        hdr, cnt = self.hdr, self.counts
        hdr.segments = br.bit(128)
        hdr.update_map = 0
        if not hdr.segments:
            self.seg_map = None     # FFmpeg's map of this frame is stale
            return
        cnt["segments"] += 1
        hdr.update_map = br.bit(128)
        if br.bit(128):                     # update segment feature data
            hdr.absolute = br.bit(128)
            hdr.seg_q = [br.signed(7) if br.bit(128) else 0
                         for _ in range(4)]
            hdr.seg_lf = [br.signed(6) if br.bit(128) else 0
                          for _ in range(4)]
        elif not key:
            cnt["segment_data_kept"] += 1
        if hdr.update_map:
            cnt["segment_map_update"] += 1
            hdr.seg_probs = [br.literal(8) if br.bit(128) else 255
                             for _ in range(3)]
        elif self.seg_map is None:
            raise ValueError("VP8: a segment map kept when none was sent (or "
                             "across a frame without segmentation)")
        else:
            cnt["segment_map_kept"] += 1

    def _partitions(self, br, data, pos):
        """The token partitions' decoders, with FFmpeg's checks."""
        n = 1 << br.literal(2)
        if n > 1:
            self.counts["partitions_2+"] += 1
        end = len(data)
        start = pos + 3 * (n - 1)
        if start > end:
            raise ValueError("VP8: the partition sizes run past the frame")
        parts = []
        for p in range(n - 1):
            size = int.from_bytes(data[pos + 3 * p: pos + 3 * p + 3],
                                  "little")
            if start + size > end:
                raise ValueError("VP8: a token partition runs past the "
                                 "frame")
            parts.append(kf.BoolDecoder(data, start, start + size))
            start += size
        if start >= end:
            raise ValueError("VP8: the last token partition is empty")
        parts.append(kf.BoolDecoder(data, start, end))
        return parts

    def _mode_prob_updates(self, br):
        cnt = self.counts
        if br.bit(128):
            self.ymode_probs = [br.literal(8) for _ in range(4)]
            cnt["ymode_prob_update"] += 1
        if br.bit(128):
            self.uv_probs = [br.literal(8) for _ in range(3)]
            cnt["uv_prob_update"] += 1
        for i in range(2):
            for j in range(19):
                if br.bit(MV_UPDATE_PROBS[i][j]):
                    v = br.literal(7) << 1
                    self.mv_probs[i][j] = v or 1
                    cnt["mv_prob_update"] += 1

    # -- the macroblock modes ------------------------------------------------
    def _key_modes(self, br, skip_prob):
        hdr = self.hdr
        seg, skip, ymode, bmodes, uvmode = kf._read_modes(
            br, hdr, self.mbw, self.mbh, skip_prob)
        if hdr.segments and not hdr.update_map:
            seg = list(self.seg_map)
        if hdr.segments:
            self.seg_map = seg
        mbs = Macroblocks(self.mbw * self.mbh)
        mbs.seg, mbs.skip, mbs.ymode, mbs.bmodes, mbs.uvmode = (
            seg, skip, ymode, bmodes, uvmode)
        return mbs

    def _inter_modes(self, br, skip_prob, probs, sign_bias):
        """Every macroblock's segment, skip flag, reference and modes
        (FFmpeg's decode_mb_mode and vp8_decode_mvs), in raster order."""
        prob_intra, prob_last, prob_gf = probs
        mbw, mbh = self.mbw, self.mbh
        n = mbw * mbh
        hdr, cnt = self.hdr, self.counts
        mbs = Macroblocks(n)
        sp = hdr.seg_probs if hdr.update_map else None
        seg = list(self.seg_map) if hdr.segments and sp is None else [0] * n
        mbs.seg = seg
        bit = br.bit
        yp, uvp, mvp = self.ymode_probs, self.uv_probs, self.mv_probs
        zero16 = [(0, 0)] * 16
        for mby in range(mbh):
            for mbx in range(mbw):
                i = mby * mbw + mbx
                if sp is not None:
                    seg[i] = bit(sp[1]) if not bit(sp[0]) else 2 + bit(sp[2])
                if skip_prob is not None:
                    mbs.skip[i] = bit(skip_prob)
                if not bit(prob_intra):
                    self._intra_mode(bit, mbs, i, yp, uvp)
                    mbs.bmv[i] = zero16
                    continue
                if bit(prob_last):
                    ref = ALTREF if bit(prob_gf) else GOLDEN
                else:
                    ref = LAST
                mbs.ref[i] = ref
                cnt[f"ref_{REF_NAMES[ref]}"] += 1
                self._inter_mb(bit, mbs, i, mbx, mby, ref, sign_bias, mvp)
        if hdr.update_map:
            self.seg_map = seg
        return mbs

    def _intra_mode(self, bit, mbs, i, yp, uvp):
        cnt = self.counts
        if not bit(yp[0]):
            m = _Y_DC
        elif not bit(yp[1]):
            m = _Y_H if bit(yp[2]) else _Y_V
        else:
            m = -1 if bit(yp[3]) else _Y_TM
        mbs.ymode[i] = m
        if m < 0:
            mbs.bmodes[i] = [_bmode(bit, BMODE_PROBS) for _ in range(16)]
            cnt["intra_bpred_inter"] += 1
        else:
            cnt["intra_i16_inter"] += 1
        mbs.uvmode[i] = kf.DC if not bit(uvp[0]) else kf.VE if not bit(
            uvp[1]) else kf.TM if bit(uvp[2]) else kf.HE

    def _inter_mb(self, bit, mbs, i, mbx, mby, ref, sign_bias, mvp):
        """The near-MV search and the MB's mode and vectors."""
        mbw, cnt = self.mbw, self.counts
        c, near, inverted = near_mvs(mbs, mbx, mby, mbw, ref, sign_bias)
        cnt["sign_bias_inversion"] += inverted
        if not bit(MODE_CONTEXTS[c[0]][0]):
            mbs.mode[i] = ZEROMV
            mbs.bmv[i] = [(0, 0)] * 16
            cnt["mode_zero"] += 1
            return
        bounds = mv_bounds(mbx, mby, mbw, self.mbh)

        def clamp(mv):
            out = clamp_mv(mv, bounds)
            if out != mv:
                cnt["mv_clamped"] += 1
            return out

        if not bit(MODE_CONTEXTS[c[1]][1]):
            mode, mv = NEARESTMV, clamp(near[1])
        elif not bit(MODE_CONTEXTS[c[2]][2]):
            mode, mv = NEARMV, clamp(near[2])
        else:
            best = clamp(near[int(c[1] >= c[0])])
            if bit(MODE_CONTEXTS[split_context(mbs, mbx, mby, mbw)][3]):
                mbs.mode[i] = SPLITMV
                cnt["mode_split"] += 1
                self._split(bit, mbs, i, mbx, mby, best, mvp)
                return
            mode = NEWMV
            mv = (best[0] + self._mv(bit, mvp[0]),
                  best[1] + self._mv(bit, mvp[1]))
        mbs.mode[i] = mode
        mbs.mv[i] = mv
        mbs.bmv[i] = [mv] * 16
        cnt[f"mode_{MV_NAMES[mode]}"] += 1

    def _mv(self, bit, p) -> int:
        v = _mv_component(bit, p)
        if abs(v) > 7:
            self.counts["mv_long"] += 1
        return v

    def _split(self, bit, mbs, i, mbx, mby, best, mvp):
        """A SPLITMV macroblock's partitioning and sub-MVs."""
        mbw, cnt = self.mbw, self.counts
        if bit(110):
            part = bit(150) if bit(111) else 2
        else:
            part = 3
        cnt[f"split_{SPLIT_NAMES[part]}"] += 1
        zero16 = [(0, 0)] * 16
        left = mbs.bmv[i - 1] if mbx else zero16
        top = mbs.bmv[i - mbw] if mby else zero16
        cur = [None] * 16
        splits = SPLITS[part]
        for n, k in enumerate(FIRST_BLOCK[part]):
            lmv = left[k + 3] if not k & 3 else cur[k - 1]
            amv = top[k + 12] if k <= 3 else cur[k - 4]
            p = submv_probs(lmv, amv)
            if not bit(p[0]):
                mv, name = lmv, "left"
            elif not bit(p[1]):
                mv, name = amv, "above"
            elif not bit(p[2]):
                mv, name = (0, 0), "zero"
            else:
                mv = (best[0] + self._mv(bit, mvp[0]),
                      best[1] + self._mv(bit, mvp[1]))
                name = "new"
            cnt[f"sub_{name}"] += 1
            for b in range(16):
                if splits[b] == n:
                    cur[b] = mv
        mbs.bmv[i] = cur
        mbs.mv[i] = mv                      # the last partition's

    # -- reconstruction ------------------------------------------------------
    def _reconstruct(self, mbs, parts, quant, key, profile, filter_type,
                     level, sharpness):
        mbw, mbh = self.mbw, self.mbh
        has_y2 = [-1 if (m == SPLITMV or (m is None and y < 0)) else 0
                  for m, y in zip(mbs.mode, mbs.ymode)]
        coefs, nz = kf._read_tokens(parts, mbw, mbh, kf._prob_table(
            self.coef), quant, mbs.seg, mbs.skip, has_y2)
        y2 = (np.array(has_y2) >= 0).reshape(mbh, mbw)
        coefs[:, :, :16, 0] = np.where(y2[..., None], kf._wht(coefs[:, :, 24]),
                                       coefs[:, :, :16, 0])
        res = kf._idct(coefs[:, :, :24])
        if key:
            Y, UV = kf._reconstruct(mbw, mbh, mbs.ymode, mbs.bmodes,
                                    mbs.uvmode, res)
        else:
            Y, UV = self._predict_inter(mbs, res, profile)
            res_y, res_uv = kf._residual_planes(res)
            for i in range(mbw * mbh):
                if mbs.ref[i] == INTRA:
                    mby, mbx = divmod(i, mbw)
                    kf._intra_mb(Y, UV, mbx, mby, mbw, mbs.ymode[i],
                                 mbs.bmodes[i], mbs.uvmode[i], res[mby, mbx],
                                 res_y[mby, mbx], res_uv[mby, mbx])
        if filter_type:
            # FFmpeg: a macroblock is skipped if flagged or if no block,
            # the Y2 block included, has a token
            nnz = nz.copy()
            nnz[..., :16] = np.where(y2[..., None], np.where(
                nz[..., :16] > 1, nz[..., :16], 0), nz[..., :16])
            coded = (nnz > 0).any(-1).reshape(-1) & ~np.array(mbs.skip, bool)
            strengths = self._strengths(mbs, coded, key, level, sharpness)
            kf._loop_filter(Y, UV, _FilterType(filter_type), mbw, mbh,
                            strengths)
        return Y, UV

    def _strengths(self, mbs, coded, key, level, sharpness):
        """FFmpeg's filter_level_for_mb for every macroblock: (limit,
        interior limit, hev threshold, inner edges)."""
        hdr, cnt = self.hdr, self.counts
        out = []
        for i in range(self.mbw * self.mbh):
            lvl = level
            if hdr.segments:
                lvl = hdr.seg_lf[mbs.seg[i]] + (0 if hdr.absolute else level)
            mode = mbs.mode[i]
            if hdr.use_lf_delta:
                lvl += hdr.ref_delta[mbs.ref[i]]
                if mode is not None:
                    lvl += hdr.mode_delta[_MODE_DELTA[mode]]
                elif mbs.ymode[i] < 0:
                    lvl += hdr.mode_delta[0]
            lvl = min(max(lvl, 0), 63)
            inner = bool(coded[i]) or mode == SPLITMV or (
                mode is None and mbs.ymode[i] < 0)
            if not inner and lvl:
                cnt["inner_edges_skipped"] += 1
            if not lvl:
                out.append((0, 0, 0, 0))
                continue
            ilevel = lvl
            if sharpness:
                ilevel >>= (sharpness + 3) >> 2
                ilevel = min(ilevel, 9 - sharpness)
            ilevel = max(ilevel, 1)
            if key:
                hev = 2 if lvl >= 40 else 1 if lvl >= 15 else 0
            else:
                hev = 3 if lvl >= 40 else 2 if lvl >= 20 else \
                    1 if lvl >= 15 else 0
            out.append((2 * lvl + ilevel, ilevel, hev, int(inner)))
        return [out[r * self.mbw:(r + 1) * self.mbw]
                for r in range(self.mbh)]

    def _predict_inter(self, mbs, res, profile):
        """Every inter macroblock predicted from its reference, 4x4 block
        by 4x4 block, plus its residual; intra macroblocks are left 0."""
        mbw, mbh = self.mbw, self.mbh
        Y = np.zeros((16 * mbh, 16 * mbw), np.int64)
        UV = np.zeros((2, 8 * mbh, 8 * mbw), np.int64)
        inter = [i for i in range(mbw * mbh) if mbs.ref[i] != INTRA]
        if not inter:
            return Y, UV
        mb = np.array(inter)
        mby, mbx = mb // mbw, mb % mbw
        ref = np.array([mbs.ref[i] for i in inter]) - 1
        mv = np.array([mbs.bmv[i] for i in inter], np.int64)   # (n, 16, 2)
        bilinear = int(profile > 0)
        # luma: 16 blocks an MB, quarter-pel vectors
        by = (16 * mby[:, None] + 4 * (np.arange(16) // 4)).reshape(-1)
        bx = (16 * mbx[:, None] + 4 * (np.arange(16) % 4)).reshape(-1)
        lmv = mv.reshape(-1, 2)
        self._count_outside(by, bx, lmv, 2, 16 * mbh, 16 * mbw)
        refs_y = np.stack([self.refs[r][0] for r in (LAST, GOLDEN, ALTREF)])
        pred = _mc(refs_y, np.repeat(ref, 16), by, bx, lmv[:, 0] * 2,
                   lmv[:, 1] * 2, bilinear)
        pred = kf._clip(pred + res[mby, mbx, :16].reshape(-1, 4, 4))
        rows = by[:, None, None] + np.arange(4)[None, :, None]
        cols = bx[:, None, None] + np.arange(4)[None, None, :]
        Y[rows, cols] = pred
        # chroma: the rounded mean of each quadrant's four luma vectors
        q = mv.reshape(-1, 2, 2, 2, 2, 2).transpose(0, 1, 3, 2, 4, 5) \
            .reshape(-1, 4, 4, 2).sum(2)                        # (n, 4, 2)
        cmv = (q + 2 + (q >> 63)) >> 2
        if profile == 3:
            cmv &= ~7
        cmv = cmv.reshape(-1, 2)
        cy = (8 * mby[:, None] + 4 * (np.arange(4) // 2)).reshape(-1)
        cx = (8 * mbx[:, None] + 4 * (np.arange(4) % 2)).reshape(-1)
        self._count_outside(cy, cx, cmv, 3, 8 * mbh, 8 * mbw)
        rows = cy[:, None, None] + np.arange(4)[None, :, None]
        cols = cx[:, None, None] + np.arange(4)[None, None, :]
        for p in range(2):
            refs_c = np.stack([self.refs[r][1][p]
                               for r in (LAST, GOLDEN, ALTREF)])
            pred = _mc(refs_c, np.repeat(ref, 4), cy, cx, cmv[:, 0],
                       cmv[:, 1], bilinear)
            r = res[mby, mbx, 16 + 4 * p:20 + 4 * p].reshape(-1, 4, 4)
            UV[p][rows, cols] = kf._clip(pred + r)
        return Y, UV

    def _count_outside(self, y, x, mv, shift, h, w):
        """Count the blocks whose reference area leaves the frame."""
        y0, x0 = y + (mv[:, 0] >> shift), x + (mv[:, 1] >> shift)
        self.counts["mv_outside"] += int(((y0 < 2) | (x0 < 2) | (
            y0 + 7 > h) | (x0 + 7 > w)).sum())

    def _update_refs(self, planes, key, update, update_last):
        old = list(self.refs)
        if key:
            self.refs = [None, planes, planes, planes]
            return
        for ref in (GOLDEN, ALTREF):
            self.refs[ref] = planes if update[ref] == INTRA else \
                old[update[ref]]
        if update_last:
            self.refs[LAST] = planes


class _FilterType:
    """The one header field ``pipeline/vp8._loop_filter`` reads."""

    def __init__(self, filter_type: int):
        self.filter_type = filter_type


def _mc(refs, ref, by, bx, mvy, mvx, bilinear: int):
    """4x4 blocks at (by, bx) predicted from ``refs[ref]`` by vectors in
    eighth pixels of that plane, extended by edge replication: the
    horizontal pass over 9 rows, clamped to bytes, then the vertical."""
    h, w = refs.shape[1:]
    fy = _FILTERS[bilinear][mvy & 7]                          # (n, 6)
    fx = _FILTERS[bilinear][mvx & 7]
    k = np.arange(-2, 7)
    rows = np.clip(by[:, None] + (mvy >> 3)[:, None] + k, 0, h - 1)
    cols = np.clip(bx[:, None] + (mvx >> 3)[:, None] + k, 0, w - 1)
    win = refs[ref[:, None, None], rows[:, :, None], cols[:, None, :]]
    tmp = sum(fx[:, t, None, None] * win[:, :, t:t + 4] for t in range(6))
    tmp = np.clip((tmp + 64) >> 7, 0, 255)
    out = sum(fy[:, t, None, None] * tmp[:, t:t + 4, :] for t in range(6))
    return np.clip((out + 64) >> 7, 0, 255)


def to_bgr(planes, width: int, height: int, full=False) -> np.ndarray:
    """Decoded planes -> (h, w, 3) uint8 BGR cropped to the frame size, as
    swscale converts ``yuv420p`` for ``cv2.VideoCapture``."""
    if height % 2:
        raise ValueError(f"VP8: a frame of odd height {height} (swscale "
                         f"converts it on its scaling path)")
    y, u, v = planes
    cw, ch = (width + 1) // 2, (height + 1) // 2
    return yuv_to_bgr(y[:height, :width].astype(np.uint8),
                      u[:ch, :cw].astype(np.uint8),
                      v[:ch, :cw].astype(np.uint8), 2, full_range=bool(full))


class Vp8Video:
    """A VP8 stream: the rate ``CAP_PROP_FPS`` gives and its frames (one
    VP8 frame each, in decode order), read as ``cv2.VideoCapture`` reads
    them: one picture per frame with ``show_frame`` 1."""

    fourcc = "VP80"

    def __init__(self, fps: float, samples: list, path: str = ""):
        if any(len(s) < 3 for s in samples):
            raise ValueError(f"{path}: a VP8 frame shorter than its tag")
        if not samples or samples[0][0] & 1:
            raise ValueError(f"{path}: a VP8 stream that does not start "
                             f"with a key frame (cv2 reads no frame of it)")
        self.fps = fps
        self.samples = samples
        self.shown = [i for i, s in enumerate(self.samples) if s[0] & 0x10]
        self.counts = collections.Counter()

    def __len__(self) -> int:
        return len(self.shown)

    def _decoded(self, stop: int):
        """(planes, width, height, full range) of the shown frames among
        samples 0..stop-1, decoded in order by a new decoder."""
        dec = Vp8Decoder()
        try:
            for s in self.samples[:stop]:
                planes = dec.decode(s)
                if planes is not None:
                    yield planes, dec.width, dec.height, dec.full_range
        finally:
            self.counts.update(dec.counts)

    def frame(self, i: int) -> np.ndarray:
        """Frame ``i`` as (h, w, 3) uint8 BGR, decoded in order from the
        first frame (a segment map may be kept across key frames)."""
        for out in self._decoded(self.shown[i] + 1):
            pass
        return to_bgr(*out)

    def frames(self):
        """The frames in order, each a zero-argument callable that converts
        it to BGR: every frame is decoded (the next ones predict from it),
        only the frames asked for are converted."""
        for out in self._decoded(len(self.samples)):
            yield lambda out=out: to_bgr(*out)
