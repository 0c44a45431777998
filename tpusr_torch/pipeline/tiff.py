"""TIFF decode in numpy and ``zlib``: what ``cv2.imdecode(IMREAD_COLOR)``
gives (swapped to RGB) for the TIFFs OpenCV reads through libtiff.

At 8 bits out, OpenCV reads every TIFF through libtiff's RGBA interface
(``TIFFReadRGBAStrip``/``TIFFReadRGBATile``) and drops the alpha; the
conversions below are that interface's (``tif_getimage.c``):

- classic TIFF and BigTIFF, either byte order, the first IFD only;
- strips or tiles, planar configuration 1 (chunky) or 2 (planar);
- compression none, LZW (libtiff's MSB-first codes with the early change
  of code width), Deflate (8 and 32946) and PackBits; predictor 2
  (horizontal differencing) at 8 and 16 bits;
- MinIsBlack and MinIsWhite at 1, 8 and 16 bits (16-bit gray is its high
  byte), RGB at 8 and 16 bits (a 16-bit sample becomes ``(v + 128) //
  257``, libtiff's ``Bitdepth16To8``), Palette at 1, 4 and 8 bits (a colour
  map with every entry under 256 is taken as 8-bit, as libtiff's
  ``checkcmap`` takes it, any other as its high bytes);
- unassociated alpha (ExtraSamples 2) premultiplies the colour, ``(c * a +
  127) // 255`` (libtiff's ``UaToAa``); associated or unspecified alpha,
  and gray's alpha, are dropped;
- the Orientation tag, applied as ``cv2.imdecode`` applies an EXIF one.

Refused by name, as OpenCV or libtiff refuse them or as this decoder
leaves them out: JPEG, old-JPEG and CCITT compression, floating-point
samples and predictor, YCbCr, CMYK, CIELab and LogLuv photometrics, gray
at 2 or 4 bits, more than 4 samples, other depths, and an uncompressed
tile whose size is not a multiple of 1024 bytes (this libtiff refuses it).

The decoder faces the network: what the IFD declares is checked before
memory is sized from it. The image must fit OpenCV's limits, the data of
its strips or tiles must be able to fill it at each codec's greatest
expansion, and each strip or tile is inflated only up to its declared
size, so a decompression bomb costs no more than the image it declares.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tpusr_torch.pipeline.jpeg import MAX_PIXELS, apply_orientation

# field types: (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                 32773: "PackBits"}
_REFUSED_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3",
                         4: "CCITT Group 4", 6: "old-style JPEG", 7: "JPEG",
                         32809: "ThunderScan", 32908: "Pixar", 34661: "JBIG",
                         34676: "SGI LogLuv", 34677: "SGI LogL",
                         34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                         50000: "Zstandard", 50001: "WebP", 50002: "JPEG XL"}
_REFUSED_PHOTOMETRICS = {4: "transparency mask", 5: "CMYK (separated)",
                         6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
                         32844: "LogL", 32845: "LogLuv"}
# the most bytes one input byte can become: Deflate's 1032:1, a 12-bit LZW
# code for a string of up to 4096 bytes, PackBits' 2 bytes for 128
_EXPANSION = {1: 1, 5: 4096 * 8 // 12 + 1, 8: 1032, 32946: 1032, 32773: 64}
# OpenCV's CV_IO_MAX_IMAGE_WIDTH and _HEIGHT
MAX_SIDE = 1 << 20


class _IFD:
    """The entries of a TIFF's first IFD, read on demand."""

    def __init__(self, body: bytes):
        self.body = body
        self.e = {b"II": "<", b"MM": ">"}.get(body[:2])
        if self.e is None or len(body) < 8:
            raise ValueError("not a TIFF image (no byte-order mark)")
        (magic,) = struct.unpack(self.e + "H", body[2:4])
        self.big = magic == 43
        if self.big:
            if len(body) < 16:
                raise ValueError("truncated BigTIFF header")
            size, _, ifd = struct.unpack(self.e + "HHQ", body[4:16])
            if size != 8:
                raise ValueError("BigTIFF with offsets of another size than 8")
        elif magic == 42:
            (ifd,) = struct.unpack(self.e + "I", body[4:8])
        else:
            raise ValueError(f"not a TIFF image (version {magic})")
        count_fmt, entry, self.inline = ("Q", 20, 8) if self.big else ("H", 12, 4)
        n_size = struct.calcsize(count_fmt)
        if ifd + n_size > len(body):
            raise ValueError("truncated TIFF: the IFD is past the end")
        (n,) = struct.unpack(self.e + count_fmt, body[ifd: ifd + n_size])
        if ifd + n_size + n * entry > len(body):
            raise ValueError("truncated TIFF IFD")
        self.entries = {}
        head = self.e + ("HHQ" if self.big else "HHI")
        for k in range(n):
            p = ifd + n_size + k * entry
            tag, typ, count = struct.unpack(
                head, body[p: p + entry - self.inline])
            self.entries.setdefault(tag, (typ, count, p + entry - self.inline))

    def get(self, tag: int, default=None) -> list | None:
        """The values of ``tag`` as a list of ints, or ``default``."""
        if tag not in self.entries:
            return default
        typ, count, p = self.entries[tag]
        if typ not in _TYPES:
            raise ValueError(f"TIFF tag {tag} has the unsupported type {typ}")
        code, size = _TYPES[typ]
        nbytes = count * size
        if nbytes > self.inline:
            (p,) = struct.unpack(self.e + ("Q" if self.big else "I"),
                                 self.body[p: p + self.inline])
        if p + nbytes > len(self.body):
            raise ValueError(f"truncated TIFF: tag {tag}'s values are past "
                             f"the end")
        return list(struct.unpack(f"{self.e}{count}{code}",
                                  self.body[p: p + nbytes]))

    def one(self, tag: int, default: int | None = None) -> int | None:
        vals = self.get(tag)
        return vals[0] if vals else default


def _lzw(data: bytes, need: int) -> bytes:
    """libtiff's ``LZWDecode``: MSB-first codes of 9 to 12 bits, the width
    growing one code early; up to ``need`` bytes."""
    if data[:2] and data[0] == 0 and data[1] & 1:
        raise ValueError("old-style (LSB-first) LZW TIFF is not supported")
    # the 24 bits from each byte: a code of up to 12 bits at any bit offset
    b = np.frombuffer(bytes(data) + b"\x00\x00", np.uint8).astype(np.int64)
    v24 = ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()
    nbits_total = 8 * len(data)
    out, n_out = [], 0
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    bit, width, prev = 0, 9, None
    while n_out < need:
        if bit + width > nbits_total:
            break
        code = (v24[bit >> 3] >> (24 - (bit & 7) - width)) & ((1 << width) - 1)
        bit += width
        if code == 257:                         # EOI
            break
        if code == 256:                         # clear
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            if code > 255:
                raise ValueError("corrupt TIFF LZW data (a code after a "
                                 "clear that is not a byte)")
            s = table[code]
        else:
            if code < len(table):
                s = table[code]
                if not s:
                    raise ValueError("corrupt TIFF LZW data")
                table.append(prev + s[:1])
            elif code == len(table):
                s = prev + prev[:1]
                table.append(s)
            else:
                raise ValueError("corrupt TIFF LZW data (a code not yet in "
                                 "the table)")
            if len(table) >= (1 << width) - 1:
                width = min(width + 1, 12)
        out.append(s)
        n_out += len(s)
        prev = s
    raw = b"".join(out)
    return raw[:need]


def _packbits(data: bytes, need: int) -> bytes:
    """libtiff's ``PackBitsDecode``, up to ``need`` bytes."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < need:
        c = data[i]
        i += 1
        if c < 128:                              # a literal of c + 1 bytes
            out += data[i: i + c + 1]
            i += c + 1
        elif c > 128:                            # a run of 257 - c bytes
            if i >= n:
                break
            out += data[i: i + 1] * (257 - c)
            i += 1
    return bytes(out[:need])


def _inflate(data: bytes, compression: int, need: int) -> bytes:
    """One strip's or tile's bytes, decoded up to ``need`` bytes; shorter
    output is refused, as libtiff refuses it."""
    if compression == 1:
        raw = data[:need]
    elif compression == 5:
        raw = _lzw(data, need)
    elif compression == 32773:
        raw = _packbits(data, need)
    else:
        try:
            raw = zlib.decompressobj().decompress(data, need)
        except zlib.error as e:
            raise ValueError(f"TIFF Deflate data does not inflate: {e}") \
                from None
    if len(raw) < need:
        raise ValueError(f"truncated TIFF {_COMPRESSIONS[compression]} data: "
                         f"{len(raw)} of {need} bytes")
    return raw


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int,
             order: str, predictor: int) -> np.ndarray:
    """A strip's or tile's bytes -> (rows, cols, spp) int samples, the
    horizontal differencing undone."""
    if bits == 16:
        s = np.frombuffer(raw, order + "u2").reshape(rows, cols, spp)
    elif bits == 8:
        s = np.frombuffer(raw, np.uint8).reshape(rows, cols, spp)
    else:        # 1 or 4 bits, one sample, rows padded to a byte
        stride = -(-cols * bits // 8)
        b = np.frombuffer(raw, np.uint8).reshape(rows, stride)
        if bits == 1:
            s = np.unpackbits(b, axis=1)[:, :cols]
        else:
            s = np.stack([b >> 4, b & 15], -1).reshape(rows, -1)[:, :cols]
        s = s[..., None]
    if predictor == 2:
        s = np.cumsum(s, axis=1, dtype=s.dtype)
    return s


def _gray_tile(s: np.ndarray, rows: int, cols: int, bits: int) -> np.ndarray:
    """The samples libtiff's ``putgreytile``/``putagreytile``/
    ``putgreytile16`` read from a chunky tile of (th, tw, spp) gray samples
    of which (rows, cols) lie in the image: they step past a row's unread
    part one byte per pixel, not ``spp * bits / 8``, so from the second row
    on they read at a drifting byte offset (the high byte of the
    little-endian word there, at 16 bits)."""
    th, tw, spp = s.shape
    nb = bits // 8
    buf = np.concatenate([s.astype("<u2" if nb == 2 else np.uint8).reshape(
        -1).view(np.uint8), np.zeros(2, np.uint8)])
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    o = r * (nb * spp * cols + tw - cols) + nb * spp * c + nb - 1
    g = buf[np.minimum(o, buf.size - 1)]
    return g.astype(np.uint16) << 8 if nb == 2 else g


def decode_tiff_u8(body: bytes,
                   expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """TIFF bytes -> (h, w, 3) uint8 RGB (see the module docstring). With
    ``expected_hw``, an image of another size (in either orientation, since
    the Orientation tag may transpose it) is refused before its data is
    read."""
    ifd = _IFD(body)
    w, h = ifd.one(256), ifd.one(257)
    if w is None or h is None:
        raise ValueError("TIFF without its ImageWidth or ImageLength")
    bits = ifd.one(258, 1)
    compression = ifd.one(259, 1)
    photometric = ifd.one(262)
    spp = ifd.one(277, 1)
    planar = ifd.one(284, 1)
    # libtiff runs the predictor for LZW and Deflate only
    predictor = ifd.one(317, 1) if compression in (5, 8, 32946) else 1
    sample_format = ifd.one(339, 1)
    extra = ifd.get(338, [])
    if compression in _REFUSED_COMPRESSIONS:
        raise ValueError(f"{_REFUSED_COMPRESSIONS[compression]}-compressed "
                         f"TIFF is not supported")
    if compression not in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {compression} is not supported")
    if photometric is None:
        raise ValueError("TIFF without a Photometric tag")
    if photometric in _REFUSED_PHOTOMETRICS:
        raise ValueError(f"{_REFUSED_PHOTOMETRICS[photometric]} TIFF is not "
                         f"supported")
    if photometric not in (0, 1, 2, 3):
        raise ValueError(f"TIFF photometric {photometric} is not supported")
    if sample_format == 3 or predictor == 3:
        raise ValueError("floating-point TIFF is not supported")
    if not 1 <= spp <= 4:
        raise ValueError(f"TIFF with {spp} samples per pixel is not supported "
                         f"(OpenCV reads 1 to 4)")
    gray = photometric in (0, 1)
    if bits not in (1, 4, 8, 16) or (bits == 4 and photometric != 3):
        raise ValueError(f"{bits}-bit TIFF is not supported (1, 8 and 16 "
                         f"bits; 4 in a palette)")
    if photometric == 3 and bits == 16:
        raise ValueError("16-bit palette TIFF is not supported")
    if photometric == 2 and (spp < 3 or bits < 8):
        raise ValueError(f"RGB TIFF of {spp} samples at {bits} bits is not "
                         f"supported")
    if bits < 8 and (spp != 1 or predictor == 2):
        raise ValueError(f"{bits}-bit TIFF with {spp} samples or a "
                         f"predictor is not supported")
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor} is not supported")
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar} is invalid")
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE) or w * h > MAX_PIXELS:
        raise ValueError(f"TIFF of {h}x{w} is over OpenCV's limits (2^30 "
                         f"pixels, 2^20 a side)")
    if expected_hw is not None and (h, w) not in (
            tuple(expected_hw), tuple(expected_hw)[::-1]):
        raise ValueError(f"expected {expected_hw[0]}x{expected_hw[1]} LR "
                         f"input, got a {h}x{w} TIFF")
    colormap = None
    if photometric == 3:
        colormap = ifd.get(320)
        if colormap is None or len(colormap) != 3 * (1 << bits):
            raise ValueError("palette TIFF without a colour map of its size")
    tiled = 322 in ifd.entries
    if tiled:
        tw, th = ifd.one(322, 0), ifd.one(323, 0)
        offsets, counts = ifd.get(324), ifd.get(325)
        if not (0 < tw <= 1 << 24 and 0 < th <= 1 << 24):
            raise ValueError(f"TIFF tiles of {th}x{tw} are invalid")
        grid = [(y, x, th, tw) for y in range(0, h, th)
                for x in range(0, w, tw)]
    else:
        rps = ifd.one(278, h) or h
        rps = min(rps, h)
        tw, th = w, rps
        offsets, counts = ifd.get(273), ifd.get(279)
        grid = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    if offsets is None or counts is None:
        raise ValueError("TIFF without its strip or tile offsets and byte "
                         "counts")
    chunk_spp = spp if planar == 1 else 1
    if tw * th * spp * max(1, bits // 8) >= 1 << 30:
        raise ValueError("TIFF tile or strip over 2^30 bytes (OpenCV's "
                         "limit)")
    row_bytes = -(-tw * chunk_spp * bits // 8)
    planes = 1 if planar == 1 else spp
    n_chunks = len(grid) * planes
    if len(offsets) < n_chunks or len(counts) < n_chunks:
        raise ValueError(f"TIFF has {len(offsets)} strip or tile offsets "
                         f"for {n_chunks} strips or tiles")
    if tiled and compression == 1 and (th * row_bytes) % 1024:
        raise ValueError(f"uncompressed TIFF tiles of {th * row_bytes} bytes "
                         f"(not a multiple of 1024) are refused by libtiff")
    needs = [rows * row_bytes for _, _, rows, _ in grid] * planes
    spans = []
    for k, need in enumerate(needs):
        off, cnt = offsets[k], counts[k]
        cnt = max(0, min(cnt, len(body) - off))
        if cnt * _EXPANSION[compression] < need:
            raise ValueError(f"truncated TIFF: strip or tile {k} has "
                             f"{cnt} bytes for {need}")
        spans.append((off, cnt))
    dtype = np.uint16 if bits == 16 else np.uint8
    img = np.empty((h, w, spp), dtype)
    for k, (off, cnt) in enumerate(spans):
        y, x, rows, cols = grid[k % len(grid)]
        plane = k // len(grid)
        raw = _inflate(body[off: off + cnt], compression, needs[k])
        s = _samples(raw, rows, tw, chunk_spp, bits, ifd.e, predictor)
        sub = s[:min(rows, h - y), :min(cols, w - x)]
        if tiled and gray and bits >= 8 and chunk_spp == spp:
            sub = _gray_tile(s, *sub.shape[:2], bits)[..., None]
        if planar == 1:
            img[y: y + sub.shape[0], x: x + sub.shape[1]] = sub
        else:
            img[y: y + sub.shape[0], x: x + sub.shape[1], plane] = sub[..., 0]
    if gray and planar == 2 and spp > 1:
        # libtiff's separate path takes gray for RGB: r = g = b = sample 0,
        # no MinIsWhite inversion, the RGB rounding and alpha
        img = np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], axis=-1)
        photometric = 2
    rgb = _to_rgb(img, photometric, bits, extra, colormap)
    orientation = ifd.one(274, 1)
    return apply_orientation(rgb, orientation if 1 <= orientation <= 8 else 1)


def _to_rgb(img: np.ndarray, photometric: int, bits: int, extra: list,
            colormap: list | None) -> np.ndarray:
    """Samples -> 8-bit RGB, as libtiff's RGBA interface converts them."""
    if photometric == 3:
        cmap = np.asarray(colormap, np.int64).reshape(3, -1).T
        if cmap.max(initial=0) >= 256:       # a 16-bit map: its high bytes
            cmap = cmap >> 8
        return cmap.astype(np.uint8)[img[..., 0]]
    if photometric in (0, 1):
        g = img[..., 0]
        if bits == 16:
            g = g >> 8
        elif bits == 1:
            g = g * 255
        g = g.astype(np.uint8)
        if photometric == 0:
            g = 255 - g
        return np.repeat(g[..., None], 3, axis=-1)
    c = img[..., :3].astype(np.int64)
    if bits == 16:
        c = (c + 128) // 257
    if extra and extra[0] == 2 and img.shape[2] > 3:      # unassociated alpha
        a = img[..., 3:4].astype(np.int64)
        if bits == 16:
            a = (a + 128) // 257
        c = (c * a + 127) // 255
    return c.astype(np.uint8)
