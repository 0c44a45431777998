"""Image files written by hand, for what neither OpenCV nor Pillow writes:
TIFF (strips or tiles, chunky or planar, none/LZW/Deflate/PackBits,
predictor 2, classic or BigTIFF, either byte order), BMP (every header,
depth, bit-field and RLE form), PNG (any colour type and bit depth, plain or
Adam7) and baseline JPEG at any sampling factors from given coefficients,
plus the scans of a JPEG as segments to edit. numpy, ``struct`` and
``zlib`` only, so that the fixture script and the tests share them.
"""

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


# ------------------------------------------------------------------ TIFF
def lzw_encode(data: bytes) -> bytes:
    """libtiff's LZW encoder: MSB-first codes of 9 to 12 bits, the width
    growing when the next free code passes the width's largest, a clear
    code when the table reaches 4094 entries."""
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    def fresh():
        return {bytes([i]): i for i in range(256)}

    table, nxt, width = fresh(), 258, 9
    emit(256, width)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            emit(256, width)
            table, nxt, width = fresh(), 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([c])
    if w:
        emit(table[w], width)
        nxt += 1
        if nxt == 4094:
            emit(256, width)
            width = 9
        elif nxt > (1 << width) - 1:
            width += 1
    emit(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:                       # a run of j - i + 1 bytes
            out += bytes([(256 - (j - i)) & 0xFF, data[i]])
            i = j + 1
            continue
        while j + 1 < n and data[j + 1] != data[j] and j - i < 127:
            j += 1
        out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


def _packed_rows(rows: np.ndarray, bits: int, order: str) -> bytes:
    """(rows, cols, spp) samples -> their bytes, each row padded to a byte."""
    if bits == 16:
        return rows.astype(order + "u2").tobytes()
    if bits == 8:
        return rows.astype(np.uint8).tobytes()
    out = b""
    for r in rows:
        flat = r.reshape(-1).astype(np.int64)
        b = ((flat[:, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
        out += np.packbits(b.reshape(-1)).tobytes()
    return out


def write_tiff(a, photometric=2, compression=1, predictor=1,
               rows_per_strip=None, tile=None, planar=1, extra=None,
               orientation=None, colormap=None, bits=None, big=False,
               order="<", sample_format=None) -> bytes:
    """(h, w, spp) or (h, w) samples -> a TIFF of one IFD. ``tile`` is
    (width, height); ``colormap`` is (2^bits, 3) 16-bit entries."""
    a = np.asarray(a)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    bits = bits or (16 if a.dtype == np.uint16 else 8)

    def encode(block):
        if predictor == 2:
            d = block.astype(np.int64)
            d[:, 1:] -= block[:, :-1].astype(np.int64)
            block = (d % (1 << bits)).astype(block.dtype)
        raw = _packed_rows(block, bits, order)
        if compression == 1:
            return raw
        if compression == 5:
            return lzw_encode(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        rb = len(raw) // block.shape[0]       # PackBits: row by row
        return b"".join(packbits(raw[i * rb:(i + 1) * rb])
                        for i in range(block.shape[0]))

    planes = [a] if planar == 1 else [a[..., s:s + 1] for s in range(spp)]
    chunks = []
    for p in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), a.dtype)
                    part = p[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
        else:
            rps = rows_per_strip or h
            chunks += [encode(p[y:y + rps]) for y in range(0, h, rps)]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [spp]), (284, 3, [planar])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if tile:
        tags += [(322, 4, [tile[0]]), (323, 4, [tile[1]])]
    else:
        tags.append((278, 4, [rows_per_strip or h]))
    if extra is not None:
        tags.append((338, 3, list(extra)))
    if orientation is not None:
        tags.append((274, 3, [orientation]))
    if colormap is not None:
        tags.append((320, 3, [int(v) for v in
                              np.asarray(colormap).T.reshape(-1)]))
    if sample_format is not None:
        tags.append((339, 3, [sample_format] * spp))
    head_len = 16 if big else 8
    data, offsets = b"", []
    for c in chunks:
        offsets.append(head_len + len(data))
        data += c + b"\0" * (len(c) % 2)
    long_type = 16 if big else 4
    tags += [(324 if tile else 273, long_type, offsets),
             (325 if tile else 279, long_type, [len(c) for c in chunks])]
    tags.sort()
    fmt = {3: "H", 4: "I", 16: "Q"}
    inline, entry = (8, 20) if big else (4, 12)
    ifd_at = head_len + len(data)
    ifd_len = (8 if big else 2) + len(tags) * entry + (8 if big else 4)
    entries, ext = b"", b""
    for tag, typ, vals in tags:
        payload = struct.pack(order + fmt[typ] * len(vals), *vals)
        if len(payload) <= inline:
            val = payload + b"\0" * (inline - len(payload))
        else:
            val = struct.pack(order + ("Q" if big else "I"),
                              ifd_at + ifd_len + len(ext))
            ext += payload + b"\0" * (len(payload) % 2)
        entries += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ,
                               len(vals)) + val
    mark = b"II" if order == "<" else b"MM"
    if big:
        head = mark + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
        ifd = struct.pack(order + "Q", len(tags)) + entries + bytes(8)
    else:
        head = mark + struct.pack(order + "HI", 42, ifd_at)
        ifd = struct.pack(order + "H", len(tags)) + entries + bytes(4)
    return head + data + ifd + ext


# ------------------------------------------------------------------- BMP
def write_bmp(width, height, bpp, pixels: bytes, compression=0,
              palette: bytes = b"", header=40, masks=None, clr_used=0):
    """A BMP of the given header size (12, 40, 108 or 124) around
    ``pixels`` (its rows as stored, padded). ``palette`` is 4-byte entries
    (3-byte for header 12); ``masks`` are written after the header."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bpp,
                           compression, len(pixels), 2835, 2835, clr_used, 0)
        info += bytes(header - 40)
    extra = struct.pack("<III", *masks) if masks is not None else b""
    off = 14 + len(info) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info
            + extra + palette + pixels)


def bmp_rows(rows: np.ndarray, bpp: int) -> bytes:
    """(h, w) indices or (h, w, n) bytes as BMP rows (top row first, as
    given), each padded to 4 bytes."""
    out = b""
    for r in rows:
        if bpp in (1, 4):
            per = 8 // bpp
            v = np.zeros(-(-len(r) // per) * per, np.uint8)
            v[:len(r)] = r
            b = np.zeros(len(v) // per, np.uint8)
            for k in range(per):
                b |= v[k::per] << (8 - bpp * (k + 1))
            raw = b.tobytes()
        else:
            raw = np.ascontiguousarray(r).tobytes()
        out += raw + bytes(-len(raw) % 4)
    return out


def rgbq(colors: np.ndarray) -> bytes:
    """(n, 3) RGB -> BMP palette entries B, G, R, 0."""
    c = np.asarray(colors, np.uint8)
    return np.concatenate([c[:, ::-1], np.zeros((len(c), 1), np.uint8)],
                          1).tobytes()


# ------------------------------------------------------------------- PNG
def png_chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data)))


def write_png(samples: np.ndarray, depth: int, color: int, interlace=0,
              palette=None, chunks=(), sub_every=2) -> bytes:
    """(h, w, ch) samples -> a PNG at ``depth`` in colour type ``color``,
    plain or Adam7, rows filtered with filter 0, or 1 (Sub) on every
    ``sub_every``-th row at depths of 8 and 16, ``chunks`` ((type, data))
    before IDAT."""
    h, w, ch = samples.shape

    def scanlines(img):
        out = b""
        bpp = max(1, ch * depth // 8)
        for k, r in enumerate(img):
            if depth == 16:
                raw = np.frombuffer(r.astype(">u2").tobytes(), np.uint8)
            elif depth == 8:
                raw = r.astype(np.uint8).reshape(-1)
            else:
                raw = np.frombuffer(_packed_rows(r[None], depth, ">"), np.uint8)
            if k % sub_every == sub_every - 1 and depth >= 8:      # Sub
                d = raw.astype(np.int64)
                d[bpp:] -= raw[:-bpp]
                out += b"\x01" + (d % 256).astype(np.uint8).tobytes()
            else:
                out += b"\x00" + raw.tobytes()
        return out

    if interlace:
        raw = b"".join(scanlines(samples[y0::dy, x0::dx])
                       for y0, x0, dy, dx in ADAM7 if h > y0 and w > x0)
    else:
        raw = scanlines(samples)
    body = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        body += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    for ctype, data in chunks:
        body += png_chunk(ctype, data)
    return (body + png_chunk(b"IDAT", zlib.compress(raw))
            + png_chunk(b"IEND", b""))


# ------------------------------------------------------------------ JPEG
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
          26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
          56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
          45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# a DC table of 5-bit codes for categories 0-11 and an AC table of 8-bit
# codes for EOB, ZRL and every (run, size) of size 1-10: simple, valid
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]


def _segment(marker: int, data: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(data) + 2) + data


def _category(v: int) -> tuple[int, int]:
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def write_jpeg(components, width, height, qtable=None, restart=0,
               sof=0xC0, adobe=None, jfif=True) -> bytes:
    """A sequential Huffman JPEG, one interleaved scan, from ``components``
    ((id, h, v, coef)): ``coef`` is (rows, cols, 64) quantised coefficients
    in natural order covering the frame's MCUs (rows = MCU rows * v)."""
    q = np.ones(64, np.int64) if qtable is None else np.asarray(qtable)
    dc_codes = {s: (i, 5) for i, s in enumerate(_DC_SYMBOLS)}
    ac_codes = {s: (i, 8) for i, s in enumerate(_AC_SYMBOLS)}
    max_h = max(c[1] for c in components)
    max_v = max(c[2] for c in components)
    mcus_w = -(-width // (8 * max_h))
    mcus_h = -(-height // (8 * max_v))
    bits = []

    def put(code, n):
        bits.extend((code >> (n - 1 - k)) & 1 for k in range(n))

    pred = [0] * len(components)
    segments = []
    for m in range(mcus_w * mcus_h):
        if restart and m and m % restart == 0:
            segments.append(bits)
            bits = []
            pred = [0] * len(components)
        my, mx = divmod(m, mcus_w)
        for ci, (_, h, v, coef) in enumerate(components):
            for by in range(v):
                for bx in range(h):
                    blk = coef[my * v + by, mx * h + bx]
                    zz = [int(blk[ZIGZAG[k]]) for k in range(64)]
                    s, extra = _category(zz[0] - pred[ci])
                    pred[ci] = zz[0]
                    put(*dc_codes[s])
                    put(extra, s)
                    run = 0
                    for k in range(1, 64):
                        if zz[k] == 0:
                            run += 1
                            continue
                        while run > 15:
                            put(*ac_codes[0xF0])
                            run -= 16
                        s, extra = _category(zz[k])
                        put(*ac_codes[(run << 4) | s])
                        put(extra, s)
                        run = 0
                    if run:
                        put(*ac_codes[0x00])
    segments.append(bits)
    scan = b""
    for k, seg in enumerate(segments):
        seg = seg + [1] * (-len(seg) % 8)
        raw = np.packbits(np.asarray(seg, np.uint8)).tobytes()
        scan += raw.replace(b"\xff", b"\xff\x00")
        if k < len(segments) - 1:
            scan += bytes([0xFF, 0xD0 + k % 8])
    dqt = _segment(0xDB, bytes([0]) + bytes(int(q[z]) for z in ZIGZAG))
    sofd = struct.pack(">BHHB", 8, height, width, len(components)) + b"".join(
        bytes([cid, (h << 4) | v, 0]) for cid, h, v, _ in components)
    dht = _segment(0xC4, bytes([0x00]) + bytes(4 * [0] + [12] + 11 * [0])
                   + bytes(_DC_SYMBOLS)
                   + bytes([0x10]) + bytes(7 * [0] + [len(_AC_SYMBOLS)]
                                           + 8 * [0]) + bytes(_AC_SYMBOLS))
    sos = bytes([len(components)]) + b"".join(
        bytes([cid, 0x00]) for cid, *_ in components) + bytes([0, 63, 0])
    head = b"\xff\xd8"
    if jfif:
        head += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        head += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                         + bytes([adobe]))
    dri = _segment(0xDD, struct.pack(">H", restart)) if restart else b""
    return (head + dqt + _segment(sof, sofd) + dht + dri + _segment(0xDA, sos)
            + scan + b"\xff\xd9")


def random_components(rng, width, height, factors, scale=40):
    """(id, h, v, coef) per (h, v) of ``factors``: smooth DC and a few
    decaying AC coefficients per block."""
    max_h = max(f[0] for f in factors)
    max_v = max(f[1] for f in factors)
    mcus_w = -(-width // (8 * max_h))
    mcus_h = -(-height // (8 * max_v))
    comps = []
    for i, (h, v) in enumerate(factors):
        rows, cols = mcus_h * v, mcus_w * h
        coef = np.zeros((rows, cols, 64), np.int64)
        coef[..., 0] = rng.integers(-60, 60, (rows, cols))
        for k in range(1, 64):
            amp = max(1, int(scale / (1 + k)))
            keep = rng.random((rows, cols)) < 0.5 / (1 + k / 8)
            coef[..., ZIGZAG[k]] = np.where(
                keep, rng.integers(-amp, amp + 1, (rows, cols)), 0)
        comps.append((i + 1, h, v, coef))
    return comps


def jpeg_segments(body: bytes) -> list[tuple[int, bytes]]:
    """(marker, whole segment bytes) in order, a scan's entropy-coded data
    kept with its SOS segment; SOI and EOI included."""
    out, pos = [(0xD8, body[:2])], 2
    while pos < len(body):
        assert body[pos] == 0xFF
        marker = body[pos + 1]
        if marker == 0xD9:
            out.append((0xD9, body[pos:pos + 2]))
            break
        (length,) = struct.unpack(">H", body[pos + 2:pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:
            while not (body[end] == 0xFF and body[end + 1] not in (0x00,)
                       and not 0xD0 <= body[end + 1] <= 0xD7):
                end += 1
        out.append((marker, body[pos:end]))
        pos = end
    return out


# ------------------------------------------------------------------ VP8
class BoolEncoder:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out, self.rng, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.rng - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.rng -= split
        else:
            self.rng = split
        while self.rng < 128:
            self.rng <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def literal(self, v: int, n: int):
        for i in reversed(range(n)):
            self.put(128, (v >> i) & 1)

    def optional_signed(self, v: int, n: int):
        """A flag, then (if set) magnitude and sign."""
        self.put(128, int(v != 0))
        if v:
            self.literal(abs(v), n)
            self.put(128, int(v < 0))

    def finish(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _tree_path(tree, leaf: int):
    """The (node index, bit) pairs that reach ``-leaf`` in a VP8 tree."""
    def walk(i, path):
        for b in (0, 1):
            t = tree[i + b]
            if t <= 0:
                if -t == leaf:
                    return path + [(i, b)]
            else:
                r = walk(2 * t, path + [(i, b)])
                if r:
                    return r
        return None
    return walk(0, [])


def _put_tokens(e: BoolEncoder, probs, ctx: int, first: int, levels) -> int:
    """One block's tokens (the inverse of libwebp's GetCoeffs); returns
    the decoder's context flag for its neighbours."""
    nz = [n for n in range(first, 16) if levels[n]]
    last = nz[-1] if nz else -1
    n, p = first, probs[first][ctx]
    while n < 16:
        if n > last:
            e.put(p[0], 0)
            break
        e.put(p[0], 1)
        while not levels[n]:
            e.put(p[1], 0)
            n += 1
            p = probs[n][0]
        e.put(p[1], 1)
        v = abs(int(levels[n]))
        if v == 1:
            e.put(p[2], 0)
            nxt = 1
        else:
            e.put(p[2], 1)
            nxt = 2
            if v <= 4:
                e.put(p[3], 0)
                e.put(p[4], int(v > 2))
                if v > 2:
                    e.put(p[5], v - 3)
            elif v <= 10:
                e.put(p[3], 1)
                e.put(p[6], 0)
                e.put(p[7], int(v > 6))
                if v <= 6:
                    e.put(159, v - 5)
                else:
                    e.put(165, (v - 7) >> 1)
                    e.put(145, (v - 7) & 1)
            else:
                e.put(p[3], 1)
                e.put(p[6], 1)
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                e.put(p[8], cat >> 1)
                e.put(p[9 + (cat >> 1)], cat & 1)
                from tpusr_torch.pipeline.vp8 import _CAT_PROBS
                extra = v - 3 - (8 << cat)
                k = len(_CAT_PROBS[cat])
                for i, q in enumerate(_CAT_PROBS[cat]):
                    e.put(q, (extra >> (k - 1 - i)) & 1)
        e.put(128, int(levels[n] < 0))
        n += 1
        p = probs[n][nxt]
    return int(last >= first)


def vp8_frame(rng, w, h, *, filter_type="normal", level=20, sharpness=0,
              partitions=1, segments=None, lf_delta=None, q_index=40,
              q_deltas=(0, 0, 0, 0, 0), prob_updates=0.0, skip_prob=None,
              i16_share=0.5, coef_share=0.5, big=0.05,
              max_coef=2048, clamping=0) -> bytes:
    """A VP8 key frame (the payload of a ``VP8 `` chunk) of random modes
    and coefficients under the given header, for what no encoder at hand
    writes: the simple filter, sharpness, filter deltas, 2-8 partitions,
    segment maps and values, quantiser deltas, probability updates.
    ``segments``: dict(quant=4 values, lf=4 values, absolute=bool,
    map_probs=3 values or None); ``lf_delta``: (4 ref deltas, 4 mode
    deltas); ``clamping``: the clamping-type bit. Levels stay within
    ``max_coef`` once dequantised, as an encoder's do (libwebp's SSE2
    transforms wrap at 16 bits beyond)."""
    from tpusr_torch.pipeline import vp8
    from tpusr_torch.pipeline.vp8_tables import (AC_Q, COEF_PROBS,
                                                 COEF_UPDATE_PROBS, DC_Q,
                                                 KF_BMODE_PROBS)
    qs = [q_index]
    if segments is not None:
        qs = [v + (0 if segments.get("absolute") else q_index)
              for v in segments["quant"]]
    steps = [max(DC_Q[min(max(q + d, 0), 127)] * 2,
                 AC_Q[min(max(q + d, 0), 127)] * 101581 >> 16)
             for q in qs for d in q_deltas]
    cap = max(4, max_coef // max(steps))
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    e = BoolEncoder()
    e.put(128, 0)
    e.put(128, clamping)
    e.put(128, int(segments is not None))
    update_map = segments is not None and segments.get("map_probs")
    if segments is not None:
        e.put(128, int(bool(update_map)))
        e.put(128, 1)
        e.put(128, int(segments.get("absolute", False)))
        for v in segments["quant"]:
            e.optional_signed(v, 7)
        for v in segments["lf"]:
            e.optional_signed(v, 6)
        if update_map:
            for p in segments["map_probs"]:
                e.put(128, 1)
                e.literal(p, 8)
    e.put(128, int(filter_type == "simple"))
    e.literal(level, 6)
    e.literal(sharpness, 3)
    e.put(128, int(lf_delta is not None))
    if lf_delta is not None:
        e.put(128, 1)
        for v in (*lf_delta[0], *lf_delta[1]):
            e.optional_signed(v, 6)
    e.literal(partitions.bit_length() - 1, 2)
    e.literal(q_index, 7)
    for v in q_deltas:
        e.optional_signed(v, 4)
    e.put(128, 0)                                  # refresh entropy probs
    probs = bytearray(COEF_PROBS)
    for i in range(len(probs)):
        upd = rng.random() < prob_updates
        e.put(COEF_UPDATE_PROBS[i], int(upd))
        if upd:
            probs[i] = int(rng.integers(1, 256))
            e.literal(probs[i], 8)
    table = []
    for t in range(4):
        bands = [[tuple(probs[((t * 8 + b) * 3 + c) * 11:
                              ((t * 8 + b) * 3 + c + 1) * 11])
                  for c in range(3)] for b in range(8)]
        table.append([bands[vp8._BANDS[n]] for n in range(17)])
    e.put(128, int(skip_prob is not None))
    if skip_prob is not None:
        e.literal(skip_prob, 8)
    parts = [BoolEncoder() for _ in range(partitions)]
    top = [vp8.DC] * (4 * mbw)
    tnz = {"y": [0] * (4 * mbw), "u": [0] * (2 * mbw), "v": [0] * (2 * mbw),
           "dc": [0] * mbw}
    for mby in range(mbh):
        left = [vp8.DC] * 4
        lnz = {"y": [0] * 4, "u": [0] * 2, "v": [0] * 2, "dc": [0]}
        tok = parts[mby % partitions]
        for mbx in range(mbw):
            if update_map:
                s = int(rng.integers(0, 4))
                mp = segments["map_probs"]
                e.put(mp[0], s >> 1)
                e.put(mp[1 + (s >> 1)], s & 1)
            skip = skip_prob is not None and rng.random() < 0.3
            if skip_prob is not None:
                e.put(skip_prob, int(skip))
            i16 = rng.random() < i16_share
            e.put(145, int(i16))
            if i16:
                m = int(rng.integers(0, 4))
                e.put(156, int(m in (vp8.TM, vp8.HE)))
                if m in (vp8.TM, vp8.HE):
                    e.put(128, int(m == vp8.TM))
                else:
                    e.put(163, int(m == vp8.VE))
                top[4 * mbx:4 * mbx + 4] = [m] * 4
                left = [m] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = int(rng.integers(0, 10))
                        prob = KF_BMODE_PROBS[(top[4 * mbx + x] * 10 + left[y])
                                              * 9:][:9]
                        for node, b in _tree_path(vp8._BMODE_TREE, m):
                            e.put(prob[node // 2], b)
                        top[4 * mbx + x] = left[y] = m
            uv = int(rng.integers(0, 4))
            e.put(142, int(uv != vp8.DC))
            if uv != vp8.DC:
                e.put(114, int(uv != vp8.VE))
                if uv != vp8.VE:
                    e.put(183, int(uv == vp8.TM))
            if skip:
                for k in ("y", "u", "v"):
                    n = 4 if k == "y" else 2
                    tnz[k][n * mbx:n * mbx + n] = [0] * n
                    lnz[k] = [0] * n
                if i16:
                    tnz["dc"][mbx] = lnz["dc"][0] = 0
                continue

            def levels(first):
                lv = [0] * 16
                if rng.random() < coef_share:
                    for n in rng.integers(first, 16, int(rng.integers(1, 5))):
                        v = int(rng.integers(1, 4))
                        if rng.random() < big:
                            v = int(rng.integers(4, cap + 1))
                        lv[n] = v if rng.random() < 0.5 else -v
                return lv

            if i16:
                ctx = tnz["dc"][mbx] + lnz["dc"][0]
                tnz["dc"][mbx] = lnz["dc"][0] = _put_tokens(
                    tok, table[1], ctx, 0, levels(0))
            first, pac = (1, table[0]) if i16 else (0, table[3])
            for y in range(4):
                for x in range(4):
                    c = 4 * mbx + x
                    f = _put_tokens(tok, pac, lnz["y"][y] + tnz["y"][c], first,
                                    levels(first))
                    tnz["y"][c] = lnz["y"][y] = f
            for k in ("u", "v"):
                for y in range(2):
                    for x in range(2):
                        c = 2 * mbx + x
                        f = _put_tokens(tok, table[2], lnz[k][y] + tnz[k][c],
                                        0, levels(0))
                        tnz[k][c] = lnz[k][y] = f
    first_part = e.finish()
    bodies = [p.finish() for p in parts]
    tag = (len(first_part) << 5) | (1 << 4)
    out = bytearray(struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a"
                    + struct.pack("<HH", w, h) + first_part)
    for b in bodies[:-1]:
        out += struct.pack("<I", len(b))[:3]
    for b in bodies:
        out += b
    return bytes(out)


def riff_chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def webp_file(chunks, vp8x=None) -> bytes:
    """A RIFF/WEBP file of ``chunks`` ((tag, payload) pairs), after a
    ``VP8X`` chunk of (flags, width, height) when given."""
    body = b"WEBP"
    if vp8x is not None:
        flags, w, h = vp8x
        body += riff_chunk(b"VP8X", bytes([flags, 0, 0, 0])
                           + (w - 1).to_bytes(3, "little")
                           + (h - 1).to_bytes(3, "little"))
    for tag, data in chunks:
        body += riff_chunk(tag, data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


# ------------------------------------------------------------------- GIF
def gif_lzw(indices, min_size: int) -> bytes:
    """GIF's LZW: a clear code first, LSB-first codes growing with the
    table, a clear code when it fills, the end code last."""
    clear = 1 << min_size
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def fresh():
        return {(i,): i for i in range(clear)}

    table, nxt, width = fresh(), clear + 2, min_size + 1
    emit(clear, width)
    w = ()
    for k in map(int, np.asarray(indices).ravel()):
        if w + (k,) in table:
            w += (k,)
            continue
        emit(table[w], width)
        if nxt < 4096:
            table[w + (k,)] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        else:
            emit(clear, width)
            table, nxt, width = fresh(), clear + 2, min_size + 1
        w = (k,)
    if w:
        emit(table[w], width)
    emit(clear + 1, width)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _gif_table(colors) -> tuple[bytes, int]:
    n = len(colors)
    bits = max(1, (n - 1).bit_length())
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:n] = colors
    return table.tobytes(), bits - 1


def write_gif(frames, width, height, palette=None, background=0,
              version=b"89a", loop=False) -> bytes:
    """A GIF of ``frames``: dicts of ``idx`` (h, w) and optional ``x``,
    ``y``, ``palette`` (local), ``transparent``, ``disposal``,
    ``interlace``, ``min_size``."""
    out = bytearray(b"GIF" + version + struct.pack("<HH", width, height))
    if palette is not None:
        table, size = _gif_table(palette)
        out += bytes([0x80 | 0x70 | size, background, 0]) + table
    else:
        out += bytes([0x70, background, 0])
    if loop:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        t = f.get("transparent")
        if t is not None or f.get("disposal"):
            out += bytes([0x21, 0xF9, 4, f.get("disposal", 0) << 2
                          | (t is not None), 10, 0, t or 0, 0])
        idx = np.asarray(f["idx"])
        h, w = idx.shape
        flags, local = 0, b""
        if f.get("palette") is not None:
            local, size = _gif_table(f["palette"])
            flags |= 0x80 | size
        if f.get("interlace"):
            flags |= 0x40
            idx = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                      np.arange(2, h, 4), np.arange(1, h, 2)])]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0),
                                     w, h, flags) + local
        ms = f.get("min_size", 8)
        out += bytes([ms]) + gif_sub_blocks(gif_lzw(idx, ms))
    return bytes(out + b"\x3b")


# ------------------------------------------- Sun raster, HDR and PFM
def write_sunras(width, height, depth, data: bytes, kind=1, colormap=None):
    """A Sun raster of ``data`` (rows already padded); ``colormap`` (n, 3)
    is stored as its red, green and blue planes."""
    cmap = b"" if colormap is None else \
        np.asarray(colormap, np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(data),
                       kind, int(colormap is not None), len(cmap)) \
        + cmap + data


def sunras_rows(rows: np.ndarray, depth: int) -> bytes:
    """(h, w[, c]) samples as Sun raster rows padded to 16 bits."""
    rows = np.asarray(rows, np.uint8)
    h = rows.shape[0]
    flat = np.packbits(rows.reshape(h, -1), axis=1) if depth == 1 \
        else rows.reshape(h, -1)
    pad = flat.shape[1] & 1
    return np.concatenate([flat, np.zeros((h, pad), np.uint8)], 1).tobytes()


def write_hdr(rgbe: np.ndarray, rle=True, header=b"#?RADIANCE\n") -> bytes:
    """A Radiance HDR of (h, w, 4) RGBE bytes: new-style RLE scanlines
    (runs of 3 or more, literals of up to 128) when ``rle``, else flat."""
    h, w, _ = rgbe.shape
    out = bytearray(header + b"FORMAT=32-bit_rle_rgbe\n\n"
                    + b"-Y %d +X %d\n" % (h, w))
    if not rle:
        return bytes(out + np.asarray(rgbe, np.uint8).tobytes())
    for row in np.asarray(rgbe, np.uint8):
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            v = row[:, c].tolist()
            i = 0
            while i < w:
                j = i
                while j < w and j - i < 127 and v[j] == v[i]:
                    j += 1
                if j - i >= 3:
                    out += bytes([128 + j - i, v[i]])
                    i = j
                    continue
                j = i + 1
                while j < w and j - i < 128 and not (
                        j + 2 < w and v[j] == v[j + 1] == v[j + 2]):
                    j += 1
                out += bytes([j - i]) + bytes(v[i:j])
                i = j
    return bytes(out)


def write_pfm(values: np.ndarray, scale=-1.0) -> bytes:
    """A PFM of (h, w) or (h, w, 3) floats, rows from the bottom up,
    little-endian for a negative scale."""
    v = np.asarray(values, np.float32)
    kind = b"PF" if v.ndim == 3 else b"Pf"
    order = "<" if scale < 0 else ">"
    return b"%s\n%d %d\n%s\n" % (kind, v.shape[1], v.shape[0],
                                  repr(float(scale)).encode()) \
        + v[::-1].astype(order + "f4").tobytes()
