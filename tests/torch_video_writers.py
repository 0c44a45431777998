"""Video files written by hand, for what ``cv2.VideoWriter`` does not write:
a VP8 stream writer that sets every interframe tool of RFC 6386 by choice
(hidden frames, the golden and altref buffers and their copies, sign
biases, kept and restored probabilities, segment maps and loop-filter
deltas that persist, each mode and split, the four profiles), and a
Matroska/WebM muxer that lays the same frames out in every way the
format allows (unknown sizes, the three lacings, BlockGroups, header
stripping, zlib, other tracks). ``struct`` and ``zlib`` only, beside the
port's own VP8 decoder, which the writer follows for the probabilities
and maps that the next frame's contexts come from; cv2 is the oracle.
"""

import struct
import zlib

from torch_image_writers import BoolEncoder, _put_tokens, _tree_path, vp8_frame
from tpusr_torch.data import vp8video as v
from tpusr_torch.pipeline import vp8 as kf
from tpusr_torch.pipeline.vp8_tables import COEF_UPDATE_PROBS


# --------------------------------------------------------------------- VP8
def put_mv_component(e: BoolEncoder, value: int, p) -> None:
    """The inverse of ``vp8video._mv_component``."""
    x = abs(value)
    if x >= 8:
        e.put(p[0], 1)
        for i in range(3):
            e.put(p[9 + i], (x >> i) & 1)
        for i in range(9, 3, -1):
            e.put(p[9 + i], (x >> i) & 1)
        if x & 0xFFF0:
            e.put(p[12], (x >> 3) & 1)
    else:
        e.put(p[0], 0)
        b0, b1, b2 = x >> 2, (x >> 1) & 1, x & 1
        e.put(p[2], b0)
        e.put(p[6] if b0 else p[3], b1)
        e.put(p[(7 if b0 else 4) + b1], b2)
    if x:
        e.put(p[1], int(value < 0))


def _signed(e: BoolEncoder, value, n: int) -> None:
    """A flagged field: None leaves it unset (flag 0), else flag 1, the
    magnitude and the sign."""
    e.put(128, int(value is not None))
    if value is not None:
        e.literal(abs(value), n)
        e.put(128, int(value < 0))


class Vp8StreamWriter:
    """Writes a VP8 stream of ``width`` x ``height`` frame by frame: key
    frames through ``torch_image_writers.vp8_frame``, interframes of random
    macroblocks under the header tools asked for. ``frames`` holds the
    frames written."""

    def __init__(self, rng, width: int, height: int):
        self.rng, self.w, self.h = rng, width, height
        self.dec = v.Vp8Decoder()
        self.frames = []

    def _push(self, data: bytes) -> bytes:
        self.dec.decode(data)
        self.frames.append(data)
        return data

    def key(self, profile: int = 0, scaling=(0, 0), show: int = 1,
            **kw) -> bytes:
        """A key frame of random modes and coefficients (``kw`` go to
        ``vp8_frame``), its tag's profile and show bit and its scaling
        bits set as asked."""
        d = bytearray(vp8_frame(self.rng, self.w, self.h, **kw))
        d[0] = (d[0] & ~0x1E) | (profile << 1) | (show << 4)
        d[7] |= scaling[0] << 6
        d[9] |= scaling[1] << 6
        return self._push(bytes(d))

    def inter(self, *, show=1, profile=0, refresh_golden=0, refresh_alt=0,
              copy_gf=0, copy_arf=0, sign_bias=(0, 0), refresh_entropy=1,
              refresh_last=1, filter_type="normal", level=20, sharpness=0,
              lf_delta=None, partitions=1, segments=None, q_index=40,
              q_deltas=(0, 0, 0, 0, 0), prob_updates=0.0, skip_prob=200,
              probs=(60, 128, 128), ymode_probs=None, uv_probs=None,
              mv_updates=0.0, intra=0.1, bpred=0.5, refs=(0.6, 0.2, 0.2),
              modes=(0.2, 0.2, 0.2, 0.2, 0.2), coef_share=0.3, max_mv=48,
              long_mv=0.2) -> bytes:
        """An interframe. ``lf_delta``: None (off), "keep" (on, no update)
        or (4 ref deltas, 4 mode deltas), None entries left as they are;
        ``segments``: None (off) or dict(map_probs=3 values or None to
        keep the map, and optionally absolute, quant, lf: 4 values each, to
        update the data); ``modes``: the weights of ZEROMV, NEARESTMV,
        NEARMV, NEWMV and SPLITMV; ``refs`` those of last, golden, altref;
        ``intra`` the share of intra macroblocks, ``bpred`` of those
        ``B_PRED``."""
        rng, dec = self.rng, self.dec
        mbw, mbh = dec.mbw, dec.mbh
        e = BoolEncoder()
        # segmentation
        e.put(128, int(segments is not None))
        seg_map = None
        if segments is not None:
            update_map = segments.get("map_probs")
            e.put(128, int(update_map is not None))
            data = "quant" in segments
            e.put(128, int(data))
            if data:
                e.put(128, int(segments.get("absolute", False)))
                for q in segments["quant"]:
                    e.optional_signed(q, 7)
                for f in segments["lf"]:
                    e.optional_signed(f, 6)
            if update_map is not None:
                for p in update_map:
                    e.put(128, 1)
                    e.literal(p, 8)
                seg_map = [int(s) for s in rng.integers(0, 4, mbw * mbh)]
        e.put(128, int(filter_type == "simple"))
        e.literal(level, 6)
        e.literal(sharpness, 3)
        e.put(128, int(lf_delta is not None))
        if lf_delta is not None:
            e.put(128, int(lf_delta != "keep"))
            if lf_delta != "keep":
                for d in (*lf_delta[0], *lf_delta[1]):
                    _signed(e, d, 6)
        e.literal(partitions.bit_length() - 1, 2)
        e.literal(q_index, 7)
        for d in q_deltas:
            e.optional_signed(d, 4)
        e.put(128, refresh_golden)
        e.put(128, refresh_alt)
        if not refresh_golden:
            e.literal(copy_gf, 2)
        if not refresh_alt:
            e.literal(copy_arf, 2)
        e.put(128, sign_bias[0])
        e.put(128, sign_bias[1])
        e.put(128, refresh_entropy)
        e.put(128, refresh_last)
        coef = bytearray(dec.coef)
        for i in range(len(coef)):
            upd = rng.random() < prob_updates
            e.put(COEF_UPDATE_PROBS[i], int(upd))
            if upd:
                coef[i] = int(rng.integers(1, 256))
                e.literal(coef[i], 8)
        e.put(128, int(skip_prob is not None))
        if skip_prob is not None:
            e.literal(skip_prob, 8)
        for p in probs:
            e.literal(p, 8)
        yp, uvp = list(dec.ymode_probs), list(dec.uv_probs)
        for new, cur in ((ymode_probs, yp), (uv_probs, uvp)):
            e.put(128, int(new is not None))
            if new is not None:
                cur[:] = new
                for p in new:
                    e.literal(p, 8)
        mvp = [list(p) for p in dec.mv_probs]
        for i in range(2):
            for j in range(19):
                upd = rng.random() < mv_updates
                e.put(v.MV_UPDATE_PROBS[i][j], int(upd))
                if upd:
                    x = int(rng.integers(0, 128))
                    mvp[i][j] = (x << 1) or 1
                    e.literal(x, 7)
        table = kf._prob_table(coef)
        bias = [0, 0, sign_bias[0], sign_bias[1]]
        mbs = v.Macroblocks(mbw * mbh)
        toks = [BoolEncoder() for _ in range(partitions)]
        tnz = {"y": [0] * (4 * mbw), "u": [0] * (2 * mbw),
               "v": [0] * (2 * mbw), "dc": [0] * mbw}
        for mby in range(mbh):
            lnz = {"y": [0] * 4, "u": [0] * 2, "v": [0] * 2, "dc": [0]}
            for mbx in range(mbw):
                i = mby * mbw + mbx
                if seg_map is not None:
                    s, sp = seg_map[i], segments["map_probs"]
                    e.put(sp[0], s >> 1)
                    e.put(sp[1 + (s >> 1)], s & 1)
                skip = skip_prob is not None and rng.random() < 0.3
                if skip_prob is not None:
                    e.put(skip_prob, int(skip))
                is_inter = rng.random() >= intra
                e.put(probs[0], int(is_inter))
                if is_inter:
                    self._inter_mb(e, mbs, i, mbx, mby, bias, probs, mvp,
                                   refs, modes, max_mv, long_mv)
                    y2 = mbs.mode[i] != v.SPLITMV
                else:
                    self._intra_mb(e, mbs, i, yp, uvp, bpred)
                    y2 = mbs.ymode[i] >= 0
                self._tokens(toks[mby % partitions], table, tnz, lnz, mbx,
                             y2, skip, coef_share)
        first = e.finish()
        tag = (len(first) << 5) | (show << 4) | (profile << 1) | 1
        out = bytearray(struct.pack("<I", tag)[:3] + first)
        bodies = [t.finish() for t in toks]
        for b in bodies[:-1]:
            out += struct.pack("<I", len(b))[:3]
        for b in bodies:
            out += b
        return self._push(bytes(out))

    def _inter_mb(self, e, mbs, i, mbx, mby, bias, probs, mvp, refs, modes,
                  max_mv, long_mv):
        rng, mbw, mbh = self.rng, self.dec.mbw, self.dec.mbh
        ref = 1 + int(rng.choice(3, p=refs))
        e.put(probs[1], int(ref != v.LAST))
        if ref != v.LAST:
            e.put(probs[2], int(ref == v.ALTREF))
        mbs.ref[i] = ref
        c, near, _ = v.near_mvs(mbs, mbx, mby, mbw, ref, bias)
        mode = int(rng.choice(5, p=modes))
        e.put(v.MODE_CONTEXTS[c[0]][0], int(mode != v.ZEROMV))
        bounds = v.mv_bounds(mbx, mby, mbw, mbh)
        mbs.mode[i] = mode
        if mode == v.ZEROMV:
            mbs.bmv[i] = [(0, 0)] * 16
            return
        e.put(v.MODE_CONTEXTS[c[1]][1], int(mode != v.NEARESTMV))
        if mode == v.NEARESTMV:
            mv = v.clamp_mv(near[1], bounds)
        else:
            e.put(v.MODE_CONTEXTS[c[2]][2], int(mode != v.NEARMV))
            if mode == v.NEARMV:
                mv = v.clamp_mv(near[2], bounds)
            else:
                best = v.clamp_mv(near[int(c[1] >= c[0])], bounds)
                ctx = v.split_context(mbs, mbx, mby, mbw)
                e.put(v.MODE_CONTEXTS[ctx][3], int(mode == v.SPLITMV))
                if mode == v.SPLITMV:
                    self._split(e, mbs, i, mbx, mby, best, mvp, max_mv,
                                long_mv)
                    return
                mv = self._new_mv(e, best, mvp, max_mv, long_mv)
        mbs.mv[i] = mv
        mbs.bmv[i] = [mv] * 16

    def _new_mv(self, e, best, mvp, max_mv, long_mv):
        rng = self.rng
        mv = []
        for k in range(2):
            if rng.random() < long_mv:
                d = int(rng.integers(8, 4 * max_mv + 9))
            else:
                d = int(rng.integers(0, 8))
            d = -d if rng.random() < 0.5 else d
            put_mv_component(e, d, mvp[k])
            mv.append(best[k] + d)
        return tuple(mv)

    def _split(self, e, mbs, i, mbx, mby, best, mvp, max_mv, long_mv):
        rng, mbw = self.rng, self.dec.mbw
        part = int(rng.integers(0, 4))
        e.put(110, int(part != 3))
        if part != 3:
            e.put(111, int(part != 2))
            if part != 2:
                e.put(150, part)
        zero16 = [(0, 0)] * 16
        left = mbs.bmv[i - 1] if mbx else zero16
        top = mbs.bmv[i - mbw] if mby else zero16
        cur = [None] * 16
        for n, k in enumerate(v.FIRST_BLOCK[part]):
            lmv = left[k + 3] if not k & 3 else cur[k - 1]
            amv = top[k + 12] if k <= 3 else cur[k - 4]
            p = v.submv_probs(lmv, amv)
            sub = int(rng.integers(0, 4))
            e.put(p[0], int(sub > 0))
            if sub:
                e.put(p[1], int(sub > 1))
                if sub > 1:
                    e.put(p[2], int(sub > 2))
            mv = (lmv, amv, (0, 0))[sub] if sub < 3 else self._new_mv(
                e, best, mvp, max_mv, long_mv)
            for b in range(16):
                if v.SPLITS[part][b] == n:
                    cur[b] = mv
        mbs.bmv[i] = cur
        mbs.mv[i] = mv

    def _intra_mb(self, e, mbs, i, yp, uvp, bpred):
        rng = self.rng
        if rng.random() < bpred:
            path = ((yp[0], 1), (yp[1], 1), (yp[3], 1))
            mbs.ymode[i] = -1
        else:
            m = int(rng.integers(0, 4))
            path = {kf.DC: ((yp[0], 0),),
                    kf.VE: ((yp[0], 1), (yp[1], 0), (yp[2], 0)),
                    kf.HE: ((yp[0], 1), (yp[1], 0), (yp[2], 1)),
                    kf.TM: ((yp[0], 1), (yp[1], 1), (yp[3], 0))}[m]
            mbs.ymode[i] = m
        for p, b in path:
            e.put(p, b)
        if mbs.ymode[i] < 0:
            for _ in range(16):
                m = int(rng.integers(0, 10))
                for node, b in _tree_path(kf._BMODE_TREE, m):
                    e.put(v.BMODE_PROBS[node // 2], b)
        uv = int(rng.integers(0, 4))
        e.put(uvp[0], int(uv != kf.DC))
        if uv != kf.DC:
            e.put(uvp[1], int(uv != kf.VE))
            if uv != kf.VE:
                e.put(uvp[2], int(uv == kf.TM))
        mbs.bmv[i] = [(0, 0)] * 16

    def _tokens(self, tok, table, tnz, lnz, mbx, y2, skip, share):
        """A macroblock's tokens: levels of 1-3 (at most 942 once
        dequantised, within the SIMD transforms' 16 bits)."""
        rng = self.rng
        if skip:
            for k, n in (("y", 4), ("u", 2), ("v", 2)):
                tnz[k][n * mbx:n * mbx + n] = [0] * n
                lnz[k] = [0] * n
            if y2:
                tnz["dc"][mbx] = lnz["dc"][0] = 0
            return

        def levels(first):
            lv = [0] * 16
            if rng.random() < share:
                for n in rng.integers(first, 16, int(rng.integers(1, 4))):
                    a = int(rng.integers(1, 4))
                    lv[n] = a if rng.random() < 0.5 else -a
            return lv

        if y2:
            ctx = tnz["dc"][mbx] + lnz["dc"][0]
            tnz["dc"][mbx] = lnz["dc"][0] = _put_tokens(tok, table[1], ctx,
                                                        0, levels(0))
        first, pac = (1, table[0]) if y2 else (0, table[3])
        for y in range(4):
            for x in range(4):
                c = 4 * mbx + x
                tnz["y"][c] = lnz["y"][y] = _put_tokens(
                    tok, pac, lnz["y"][y] + tnz["y"][c], first,
                    levels(first))
        for k in ("u", "v"):
            for y in range(2):
                for x in range(2):
                    c = 2 * mbx + x
                    tnz[k][c] = lnz[k][y] = _put_tokens(
                        tok, table[2], lnz[k][y] + tnz[k][c], 0, levels(0))


# ----------------------------------------------------------------- EBML
def ebml_id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def ebml_size(n: int, width: int = 0) -> bytes:
    """A size as an EBML number of ``width`` bytes (the shortest if 0);
    ``n`` None is the unknown size."""
    if n is None:
        return b"\x01\xff\xff\xff\xff\xff\xff\xff"
    width = width or next(k for k in range(1, 9) if n < (1 << (7 * k)) - 1)
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def el(eid: int, body, size_width: int = 0, unknown: bool = False) -> bytes:
    """An element: ``body`` bytes, an int (unsigned), a str (ASCII), a
    float (8 bytes) or a list of elements."""
    if isinstance(body, list):
        body = b"".join(body)
    elif isinstance(body, bool) or isinstance(body, int):
        body = body.to_bytes(max(1, (body.bit_length() + 7) // 8), "big")
    elif isinstance(body, float):
        body = struct.pack(">d", body)
    elif isinstance(body, str):
        body = body.encode("ascii")
    return ebml_id(eid) + ebml_size(None if unknown else len(body),
                                    size_width) + body


def lace(frames, kind: str) -> tuple[int, bytes]:
    """(the lacing flag bits, the lace header + frames) of ``frames`` in
    Xiph, EBML or fixed lacing."""
    n = len(frames)
    head = bytes([n - 1])
    if kind == "xiph":
        for f in frames[:-1]:
            head += b"\xff" * (len(f) // 255) + bytes([len(f) % 255])
        return 1 << 1, head + b"".join(frames)
    if kind == "fixed":
        assert len({len(f) for f in frames}) == 1
        return 2 << 1, head + b"".join(frames)
    head += ebml_size(len(frames[0]))
    for a, b in zip(frames, frames[1:-1]):
        d = len(b) - len(a)
        for w in range(1, 9):
            bias = (1 << (7 * w - 1)) - 1
            if -bias <= d <= bias:
                head += ebml_size(d + bias, w)
                break
    return 3 << 1, head + b"".join(frames)


def block_payload(track: int, timecode: int, flags: int, body: bytes) -> bytes:
    return ebml_size(track) + struct.pack(">hB", timecode, flags) + body


def mkv(codec: str, width: int, height: int, frames, *, doctype="webm",
        default_duration=None, private=b"", encoding=None, lacing=None,
        block_group=False, unknown_sizes=False, audio=False,
        frames_per_cluster=8, timecode_ms=40) -> bytes:
    """A Matroska/WebM file of one video track (track 1) holding
    ``frames``. ``encoding``: None, ("strip", the stripped bytes) or
    ("zlib",) — the frames given are the encoded ones; ``lacing``: None or
    "xiph", "ebml", "fixed" (pairs of frames a block); ``block_group``:
    BlockGroups instead of SimpleBlocks; ``unknown_sizes``: the Segment
    and the Clusters of unknown size; ``audio``: a PCM track 2 with a block
    after every video block."""
    video = [el(0xB0, width), el(0xBA, height)]
    entry = [el(0xD7, 1), el(0x73C5, 1), el(0x83, 1), el(0x86, codec),
             el(0xE0, video)]
    if default_duration:
        entry.append(el(0x23E383, default_duration))
    if private:
        entry.append(el(0x63A2, private))
    if encoding is not None:
        comp = [el(0x4254, 3 if encoding[0] == "strip" else 0)]
        if encoding[0] == "strip":
            comp.append(el(0x4255, encoding[1]))
        entry.append(el(0x6D80, [el(0x6240, [
            el(0x5031, 0), el(0x5032, 1), el(0x5033, 0), el(0x5034, comp)])]))
    tracks = [el(0xAE, entry)]
    if audio:
        tracks.append(el(0xAE, [el(0xD7, 2), el(0x73C5, 2), el(0x83, 2),
                                el(0x86, "A_PCM/INT/LIT"),
                                el(0xE1, [el(0xB5, 8000.0), el(0x9F, 1),
                                          el(0x6264, 16)])]))
    info = el(0x1549A966, [el(0x2AD7B1, 1000000), el(0x4D80, "tpusr"),
                           el(0x5741, "tpusr")])
    clusters = []
    step = 2 if lacing else 1
    groups = [frames[k:k + step] for k in range(0, len(frames), step)]
    per = max(1, frames_per_cluster // step)
    for c in range(0, len(groups), per):
        body = [el(0xE7, c * step * timecode_ms)]
        for k, g in enumerate(groups[c:c + per]):
            tc = k * step * timecode_ms
            key = 0x80 if (g[0][0] & 1) == 0 else 0
            if lacing and len(g) > 1:
                bits, payload = lace(g, lacing)
            else:
                bits, payload = 0, g[0]
            if block_group:
                body.append(el(0xA0, [el(0xA1, block_payload(1, tc, bits,
                                                             payload)),
                                      el(0x9B, timecode_ms)]
                               + ([] if key else [el(0xFB, 1)])))
            else:
                body.append(el(0xA3, block_payload(1, tc, key | bits,
                                                   payload)))
            if audio:
                pcm = bytes((7 * k + c) % 256 for _ in range(64))
                body.append(el(0xA3, block_payload(2, tc, 0x80, pcm)))
        clusters.append(el(0x1F43B675, body, unknown=unknown_sizes))
    head = el(0x1A45DFA3, [el(0x4286, 1), el(0x42F7, 1), el(0x42F2, 4),
                           el(0x42F3, 8), el(0x4282, doctype), el(0x4287, 4),
                           el(0x4285, 2)])
    segment = [el(0xEC, bytes(20)), info, el(0x1654AE6B, tracks)] + clusters
    return head + el(0x18538067, segment, unknown=unknown_sizes)


def encode_frames(frames, encoding):
    """The frames as a ContentEncoding stores them."""
    if encoding is None:
        return list(frames)
    if encoding[0] == "zlib":
        return [zlib.compress(f) for f in frames]
    strip = encoding[1]
    assert all(f.startswith(strip) for f in frames)
    return [f[len(strip):] for f in frames]


def random_tools_stream(rng, width: int, height: int, frames: int = 12,
                        profile: int = 0) -> list:
    """A stream whose interframes draw their header tools at random from
    ``rng``: hidden frames, buffer refreshes and copies, sign biases, kept
    entropy, filter and segment changes."""
    w = Vp8StreamWriter(rng, width, height)
    w.key(profile=profile, level=int(rng.integers(0, 40)))
    for t in range(frames - 1):
        r = lambda p: int(rng.random() < p)  # noqa: E731
        seg = None
        if r(0.4):
            seg = {"map_probs": [int(x) for x in rng.integers(1, 256, 3)]}
            if r(0.5):
                seg.update(quant=[int(x) for x in rng.integers(-20, 21, 4)],
                           lf=[int(x) for x in rng.integers(-15, 16, 4)],
                           absolute=r(0.3))
        w.inter(show=1 - r(0.15), profile=profile,
                refresh_golden=r(0.3), refresh_alt=r(0.3),
                copy_gf=int(rng.integers(0, 4)),
                copy_arf=int(rng.integers(0, 4)),
                sign_bias=(r(0.4), r(0.4)), refresh_entropy=1 - r(0.3),
                refresh_last=1 - r(0.2),
                filter_type="simple" if r(0.3) else "normal",
                level=int(rng.integers(0, 50)),
                sharpness=int(rng.integers(0, 8)),
                lf_delta=None if r(0.3) else (
                    [int(x) if r(0.6) else None for x in
                     rng.integers(-20, 21, 4)],
                    [int(x) if r(0.6) else None for x in
                     rng.integers(-20, 21, 4)]),
                partitions=int(rng.choice([1, 2, 4])), segments=seg,
                q_index=int(rng.integers(10, 80)),
                prob_updates=0.02 * r(0.5), mv_updates=0.3 * r(0.5),
                ymode_probs=[int(x) for x in rng.integers(1, 256, 4)]
                if r(0.3) else None,
                uv_probs=[int(x) for x in rng.integers(1, 256, 3)]
                if r(0.3) else None,
                skip_prob=None if r(0.2) else int(rng.integers(1, 256)),
                probs=tuple(int(x) for x in rng.integers(20, 240, 3)))
    return w.frames
