"""Lossless WebP (VP8L) in numpy, as libwebp's ``vp8l_dec.c`` decodes it:
the image of a ``VP8L`` chunk, or the headerless stream of an ``ALPH``
chunk.

- Bits are read least significant first; reading past the end of the data
  is an error (libwebp's ``eos_``: past the data, or past 64 bits when
  there are fewer).
- Prefix codes: "simple" codes of one or two symbols, or code lengths
  coded with the 19-symbol code-length code (repeat codes 16, 17, 18, an
  optional maximum symbol count); a code of one symbol takes no bits, any
  other must be complete.
- The colour cache (``0x1e35a7bd`` hash, 1-11 bits), LZ77 backward
  references with the 120 short plane codes of ``kCodeToPlane``, copies
  that overlap their source, and meta prefix codes (an entropy image whose
  red and green bytes pick each tile's group of five codes).
- The transforms, undone in the reverse of their order in the stream:
  predictor (14 modes; the first row from the left, the first column from
  above, the last pixel's top-right the row's first), cross-colour,
  subtract-green and colour indexing with pixel bundling (indices past
  the palette transparent black).

Anything libwebp refuses (a transform twice, cache bits out of range, an
incomplete or oversubscribed code, a reference before the first pixel or
past the last) raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np

SIGNATURE = 0x2F
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)
# kCodeToPlane: (dy << 4) | (8 - dx) of the 120 short distance codes
_CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54,
    58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52,
    60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2,
    103, 105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120,
    1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115,
    125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112)
_ALPHABET = (256 + 24, 256, 256, 256, 40)      # green, red, blue, alpha, dist
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)


class _Reader:
    """LSB-first bits of ``data``; ``consumed()`` past ``limit`` is
    libwebp's end of stream."""

    __slots__ = ("data", "pos", "val", "nb", "limit")

    def __init__(self, data: bytes):
        self.data, self.pos, self.val, self.nb = data, 0, 0, 0
        self.limit = max(8 * len(data), 64)

    def consumed(self) -> int:
        return 8 * self.pos - self.nb

    def check(self):
        if self.consumed() > self.limit:
            raise ValueError("VP8L stream ends early")

    def bits(self, n: int) -> int:
        if self.nb < n:
            self.val |= int.from_bytes(self.data[self.pos:self.pos + 4],
                                       "little") << self.nb
            self.pos += 4
            self.nb += 32
        v = self.val & ((1 << n) - 1)
        self.val >>= n
        self.nb -= n
        return v

    def sym(self, code) -> int:
        lut, width = code
        if self.nb < width:
            self.val |= int.from_bytes(self.data[self.pos:self.pos + 4],
                                       "little") << self.nb
            self.pos += 4
            self.nb += 32
        e = lut[self.val & ((1 << width) - 1)]
        n = e & 15
        self.val >>= n
        self.nb -= n
        return e >> 4


def _build(lengths: list[int]):
    """A canonical prefix code from its code lengths -> (lookup of
    ``(symbol << 4) | length`` by the next ``width`` bits, width)."""
    syms = [s for s, n in enumerate(lengths) if n]
    if not syms:
        raise ValueError("VP8L prefix code without symbols")
    if len(syms) == 1:
        return [syms[0] << 4], 0
    count = [0] * 16
    for s in syms:
        count[lengths[s]] += 1
    open_ = 1
    for n in range(1, 16):
        open_ = 2 * open_ - count[n]
        if open_ < 0:
            raise ValueError("VP8L prefix code is oversubscribed")
    if open_:
        raise ValueError("VP8L prefix code is incomplete")
    width = max(lengths[s] for s in syms)
    lut = np.zeros(1 << width, np.int64)
    code = 0
    for n in range(1, width + 1):
        for s in (s for s in syms if lengths[s] == n):
            rev = int(format(code, f"0{n}b")[::-1], 2)
            lut[rev::1 << n] = (s << 4) | n
            code += 1
        code <<= 1
    return lut.tolist(), width


def _read_code(br: _Reader, alphabet: int):
    """ReadHuffmanCode: one prefix code over ``alphabet`` symbols."""
    lengths = [0] * alphabet
    if br.bits(1):                                  # simple code
        n = br.bits(1) + 1
        for i in range(n):
            s = br.bits(8 if i or br.bits(1) else 1)
            if s < alphabet:
                lengths[s] = 1
    else:
        cl = [0] * 19
        for i in range(br.bits(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.bits(3)
        cl_code = _build(cl)
        if br.bits(1):
            max_symbol = 2 + br.bits(2 + 2 * br.bits(3))
            if max_symbol > alphabet:
                raise ValueError("VP8L code-length count past its alphabet")
        else:
            max_symbol = alphabet
        s, prev = 0, 8
        while s < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            c = br.sym(cl_code)
            if c < 16:
                lengths[s] = c
                s += 1
                if c:
                    prev = c
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
                repeat = br.bits(extra) + offset
                if s + repeat > alphabet:
                    raise ValueError("VP8L code-length repeat past its "
                                     "alphabet")
                lengths[s:s + repeat] = [prev if c == 16 else 0] * repeat
                s += repeat
    br.check()
    return _build(lengths)


def _prefix_value(sym: int, br: _Reader) -> int:
    """GetCopyDistance/GetCopyLength: a prefix symbol and its extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.bits(extra) + 1


def _decode_pixels(br: _Reader, w: int, h: int, cache_bits: int,
                   level0: bool, tools: dict | None = None) -> np.ndarray:
    """The prefix codes, then the (h, w) uint32 ARGB pixels (LZ77, cache,
    meta codes)."""
    meta, mbits, mw = None, 0, 1
    if level0 and br.bits(1):
        mbits = br.bits(3) + 2
        if tools is not None:
            tools["meta_bits"] = mbits
        mw = (w + (1 << mbits) - 1) >> mbits
        mh = (h + (1 << mbits) - 1) >> mbits
        meta = ((_decode_sub(br, mw, mh) >> 8) & 0xFFFF).ravel().tolist()
    n_groups = max(meta) + 1 if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, a + (cache_size if j == 0 else 0))
                       for j, a in enumerate(_ALPHABET)])
    total = w * h
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    cached = 0
    i = x = y = 0
    g = groups[0]
    sym = br.sym
    while i < total:
        if meta is not None:
            g = groups[meta[(y >> mbits) * mw + (x >> mbits)]]
        code = sym(g[0])
        if code < 256:
            red = sym(g[1])
            blue = sym(g[2])
            out[i] = sym(g[3]) << 24 | red << 16 | code << 8 | blue
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
                if br.consumed() > br.limit:
                    break
        elif code < 280:
            length = _prefix_value(code - 256, br)
            dcode = _prefix_value(sym(g[4]), br)
            if dcode > 120:
                dist = dcode - 120
            else:
                p = _CODE_TO_PLANE[dcode - 1]
                dist = max((p >> 4) * w + 8 - (p & 15), 1)
            if dist > i or length > total - i:
                raise ValueError("VP8L backward reference outside the image")
            if br.consumed() > br.limit:
                break
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            i += length
            y, x = divmod(i, w)
        else:
            key = code - 280
            if key >= cache_size:
                raise ValueError("VP8L colour cache code without a cache")
            for k in range(cached, i):
                v = out[k]
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
            cached = i
            out[i] = cache[key]
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
    br.check()
    return np.array(out, np.uint32).reshape(h, w)


def _decode_sub(br: _Reader, w: int, h: int) -> np.ndarray:
    """A sub-image (entropy, predictor, cross-colour or palette image):
    its own cache bits, no transforms, no meta codes."""
    return _decode_pixels(br, w, h, _cache_bits(br), level0=False)


def _cache_bits(br: _Reader) -> int:
    if not br.bits(1):
        return 0
    bits = br.bits(4)
    if not 1 <= bits <= 11:
        raise ValueError(f"VP8L colour cache of {bits} bits")
    return bits


def decode_stream(data: bytes, w: int, h: int) -> np.ndarray:
    """A level-0 VP8L stream without the 5-byte header (an ``ALPH``
    chunk's) -> (h, w) uint32 ARGB."""
    return _decode_level0(_Reader(data), w, h)


_TRANSFORM_NAMES = ("predictor", "cross-colour", "subtract-green",
                    "colour-indexing")


def _decode_level0(br: _Reader, w: int, h: int,
                   tools: dict | None = None) -> np.ndarray:
    transforms = []
    xsize = w
    seen = set()
    while br.bits(1):
        kind = br.bits(2)
        if kind in seen:
            raise ValueError("VP8L transform present twice")
        seen.add(kind)
        if kind in (PREDICTOR, CROSS_COLOR):
            bits = br.bits(3) + 2
            sub = _decode_sub(br, (xsize + (1 << bits) - 1) >> bits,
                              (h + (1 << bits) - 1) >> bits)
            transforms.append((kind, xsize, bits, sub))
        elif kind == COLOR_INDEXING:
            n = br.bits(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _decode_sub(br, n, 1).ravel()
            transforms.append((kind, xsize, bits, _expand_palette(pal, bits)))
            xsize = (xsize + (1 << bits) - 1) >> bits
        else:
            transforms.append((kind, xsize, 0, None))
    cache_bits = _cache_bits(br)
    if tools is not None:
        tools.update(transforms=[_TRANSFORM_NAMES[t[0]] for t in transforms],
                     cache_bits=cache_bits, meta_bits=0)
    img = _decode_pixels(br, xsize, h, cache_bits, True, tools)
    for kind, tw, bits, data in reversed(transforms):
        if kind == PREDICTOR:
            img = _unpredict(img, bits, data)
        elif kind == CROSS_COLOR:
            img = _uncross(img, bits, data)
        elif kind == SUBTRACT_GREEN:
            g = (img >> 8) & 0xFF
            img = (img & 0xFF00FF00) | (((img >> 16) + g) & 0xFF) << 16 \
                | ((img + g) & 0xFF)
        else:
            img = _unindex(img, tw, bits, data)
    return img.astype(np.uint32)


def _expand_palette(pal: np.ndarray, bits: int) -> np.ndarray:
    """ExpandColorMap: the palette's bytes summed in turn, padded with 0
    to ``1 << (8 >> bits)`` entries."""
    b = pal.astype("<u4").view(np.uint8).reshape(-1, 4).astype(np.int64)
    b = np.cumsum(b, 0) & 0xFF
    out = np.zeros(1 << (8 >> bits), np.uint32)
    out[:len(pal)] = (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16
                      | b[:, 3] << 24).astype(np.uint32)[:len(out)]
    return out


def _unindex(img: np.ndarray, w: int, bits: int, pal: np.ndarray):
    idx = ((img >> 8) & 0xFF).astype(np.int64)
    if bits:
        bpp = 8 >> bits
        k = np.arange(w)
        idx = (idx[:, k >> bits] >> ((k & ((1 << bits) - 1)) * bpp)) \
            & ((1 << bpp) - 1)
    return pal[idx]


def _uncross(img: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    h, w = img.shape
    m = data[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]

    def s8(v):
        return ((v.astype(np.int64) & 0xFF) ^ 0x80) - 0x80

    g2r, g2b, r2b = s8(m), s8(m >> 8), s8(m >> 16)
    green = s8(img >> 8)
    red = (img.astype(np.int64) >> 16 & 0xFF) + ((g2r * green) >> 5)
    red &= 0xFF
    blue = (img.astype(np.int64) & 0xFF) + ((g2b * green) >> 5) \
        + ((r2b * s8(red)) >> 5)
    return ((img.astype(np.int64) & 0xFF00FF00) | red << 16
            | (blue & 0xFF)).astype(np.uint32)


# --------------------------------------------------------- predictor
def _add(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(t: int, left: int, tl: int) -> int:
    d = 0
    for s in (24, 16, 8, 0):
        c = tl >> s & 0xFF
        d += abs((left >> s & 0xFF) - c) - abs((t >> s & 0xFF) - c)
    return t if d <= 0 else left


def _clamp_full(a: int, b: int, c: int) -> int:
    v = 0
    for s in (24, 16, 8, 0):
        x = (a >> s & 0xFF) + (b >> s & 0xFF) - (c >> s & 0xFF)
        v |= (0 if x < 0 else 255 if x > 255 else x) << s
    return v


def _clamp_half(a: int, c: int) -> int:
    v = 0
    for s in (24, 16, 8, 0):
        x, y = a >> s & 0xFF, c >> s & 0xFF
        d = x - y
        x += d // 2 if d >= 0 else -((-d) // 2)         # C's truncation
        v |= (0 if x < 0 else 255 if x > 255 else x) << s
    return v


def _predict(mode: int, left: int, t: int, tl: int, tr: int) -> int:
    if mode == 1:
        return left
    if mode == 5:
        return _avg2(_avg2(left, tr), t)
    if mode == 6:
        return _avg2(left, tl)
    if mode == 7:
        return _avg2(left, t)
    if mode == 10:
        return _avg2(_avg2(left, tl), _avg2(t, tr))
    if mode == 11:
        return _select(t, left, tl)
    if mode == 12:
        return _clamp_full(left, t, tl)
    return _clamp_half(_avg2(left, t), tl)              # 13


_USES_LEFT = np.array([m in (1, 5, 6, 7, 10, 11, 12, 13)
                       for m in range(16)])


def _unpredict(res: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    """PredictorInverseTransform_C, row by row: the modes that do not read
    the left pixel at once, the others in turn."""
    h, w = res.shape
    out = np.empty((h, w), np.uint32)
    row = res[0].tolist()
    acc = 0xFF000000
    for x in range(w):
        acc = _add(row[x], acc)
        row[x] = acc
    out[0] = row
    xs = np.arange(w)
    for y in range(1, h):
        modes = ((data[y >> bits, xs >> bits] >> 8) & 0xF).astype(np.int64)
        modes[0] = 2
        top = out[y - 1]
        tl = np.concatenate([top[:1], top[:-1]])
        first = _add(int(res[y, 0]), int(top[0]))
        tr = np.concatenate([top[1:], np.array([first], np.uint32)])
        pred = np.select(
            [modes == 0, modes == 2, modes == 3, modes == 4, modes == 8,
             modes == 9, modes >= 14],
            [np.full(w, 0xFF000000, np.uint32), top, tr, tl, _avg2(tl, top),
             _avg2(top, tr), np.full(w, 0xFF000000, np.uint32)], 0)
        cur = res[y]
        r = ((((cur & 0xFF00FF00) + (pred & 0xFF00FF00)) & 0xFF00FF00)
             | (((cur & 0x00FF00FF) + (pred & 0x00FF00FF)) & 0x00FF00FF))
        left_xs = np.nonzero(_USES_LEFT[modes])[0].tolist()
        if left_xs:
            rl, tl_l, t_l, tr_l = r.tolist(), tl.tolist(), top.tolist(), \
                tr.tolist()
            cl, ml = cur.tolist(), modes.tolist()
            for x in left_xs:
                rl[x] = _add(cl[x], _predict(ml[x], rl[x - 1], t_l[x],
                                             tl_l[x], tr_l[x]))
            r = rl
        out[y] = r
    return out


# ------------------------------------------------------------ entry points
def image_size(chunk: bytes) -> tuple[int, int]:
    """(width, height) of a ``VP8L`` chunk, with libwebp's header checks."""
    if len(chunk) < 5 or chunk[0] != SIGNATURE or chunk[4] >> 5:
        raise ValueError("VP8L chunk without its signature or version 0")
    v = int.from_bytes(chunk[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1


def decode_image(data: bytes, tools: dict | None = None) -> np.ndarray:
    """The image of a ``VP8L`` chunk (its data read on to the end of
    ``data``) -> (h, w) uint32 ARGB; ``tools``, when given, gets the
    transforms in stream order, the cache and meta-code bits."""
    w, h = image_size(data)
    br = _Reader(data)
    br.bits(8)
    br.bits(32)
    return _decode_level0(br, w, h, tools)
