"""Zstandard (RFC 8878) of the port's own: a decoder, and the encoder the
port's checkpoints need.

The JAX package's Orbax checkpoints hold every array chunk as a zstd frame
(tensorstore's zarr ``zstd`` compressor); the card's machine has no
``zstandard`` and Python 3.12 none in its standard library, so the port
decodes them here, as ``hdf5.py`` reads Keras files.

    data = zstd.decompress(frame_bytes, max_size=n, device="cuda")
    frame = zstd.compress(data)

**Decoder.** Frames one after another, skippable frames; raw, RLE and
compressed blocks; literals raw, RLE, Huffman-coded (one or four streams)
and treeless (the frame's last Huffman table); sequences with predefined,
RLE, FSE and repeat tables; repeat offsets with the literal-length-0 rule;
the content checksum (XXH64) where the frame sets its flag. A dictionary
is refused by name. The window, the frame's content size and every block
size are checked before anything is sized from them.

Huffman literals, nearly all of a weight array's bytes, are decoded with
no loop over symbols, on ``device``: every bit position of a stream looks
its 11-bit window up in the table, which gives the position after that
position's symbol; pointer doubling over those successors then finds the
chain that starts at the stream's first bit, whose symbols are the
literals. All the streams of a frame go through at once, in torch (in
batches of at most ``_BATCH_BITS`` positions). FSE sequences are decoded
one by one: a weight array has few.

**Encoder.** One frame with its content size, in blocks of 128 KiB: an RLE
block where a block is one byte value (the zero moments), else a block of
Huffman-coded literals and no sequences (four streams, or one below 1 KiB;
codes of at most 11 bits, their weights FSE-coded), or a raw block where
that does not shrink it. Codes are looked up by table and the bits packed
by a cumulative sum, with no loop over symbols either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MAGIC = 0xFD2FB528
SKIPPABLE = (0x184D2A50, 0x184D2A5F)
BLOCK_MAX = 1 << 17
WINDOW_MAX = 1 << 31        # what a 32-bit decoder accepts
HUF_MAX_BITS = 11
_BATCH_BITS = 1 << 22
_M64 = (1 << 64) - 1


class ZstdError(ValueError):
    """A frame that is truncated, corrupt, or outside what this codec
    decodes."""


# --------------------------------------------------------------- bit readers
class _Backward:
    """A backward bit stream (FSE, Huffman): read from the last byte, whose
    highest set bit marks the start, towards byte 0; bits before byte 0
    read as zeros and count as an overflow (``pos < 0``)."""

    def __init__(self, data):
        if not len(data) or data[-1] == 0:
            raise ZstdError("bit stream without its end marker")
        self.data = bytes(data)
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        top = p + n
        if p >= 0:
            v = int.from_bytes(self.data[p >> 3:(top + 7) >> 3], "little")
            return (v >> (p & 7)) & ((1 << n) - 1)
        if top <= 0:
            return 0
        v = int.from_bytes(self.data[:(top + 7) >> 3], "little")
        return ((v & ((1 << top) - 1)) << -p) & ((1 << n) - 1)


# ---------------------------------------------------------------------- FSE
def _fse_table(norm: list[int], al: int):
    """RFC 8878 4.1.1: the decoding table of a normalised distribution
    (-1: a "less than 1" symbol) -> (symbol, nbBits, baseline) per state."""
    size = 1 << al
    sym = [0] * size
    high = size - 1
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nxt = [1 if c == -1 else c for c in norm]
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        ns = nxt[s]
        nxt[s] += 1
        nb[u] = al - (ns.bit_length() - 1)
        base[u] = (ns << nb[u]) - size
    return sym, nb, base


def _read_fse_dist(data, off: int, end: int, max_al: int, max_sym: int):
    """A normalised distribution (RFC 8878 4.1.1) at ``data[off:end]``
    -> (norm, accuracy log, offset after it)."""
    x = int.from_bytes(data[off:min(end, off + 512)], "little")
    avail = 8 * (min(end, off + 512) - off)
    al = (x & 15) + 5
    if al > max_al:
        raise ZstdError(f"FSE accuracy log {al} above {max_al}")
    bit = 4
    remaining = (1 << al) + 1
    threshold = 1 << al
    nbits = al + 1
    norm: list[int] = []
    prev0 = False
    while remaining > 1 and len(norm) <= max_sym:
        if prev0:
            n0 = len(norm)
            while True:
                r = (x >> bit) & 3
                bit += 2
                n0 += r
                if r != 3:
                    break
            if n0 > max_sym:
                raise ZstdError("FSE distribution runs past its alphabet")
            norm += [0] * (n0 - len(norm))
        mx = (2 * threshold - 1) - remaining
        b = x >> bit
        if (b & (threshold - 1)) < mx:
            c = b & (threshold - 1)
            bit += nbits - 1
        else:
            c = b & (2 * threshold - 1)
            if c >= threshold:
                c -= mx
            bit += nbits
        c -= 1
        remaining -= abs(c)
        norm.append(c)
        prev0 = c == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or bit > avail:
        raise ZstdError("corrupt FSE distribution")
    return norm, al, off + ((bit + 7) >> 3)


def _write_fse_dist(norm: list[int], al: int) -> bytes:
    """The inverse of ``_read_fse_dist`` (zstd's FSE_writeNCount)."""
    x, bit = al - 5, 4
    remaining = (1 << al) + 1
    threshold = 1 << al
    nbits = al + 1
    s = 0
    prev0 = False
    while remaining > 1:
        if prev0:
            start = s
            while norm[s] == 0:
                s += 1
            n = s - start
            while n >= 3:
                x |= 3 << bit
                bit += 2
                n -= 3
            x |= n << bit
            bit += 2
        c = norm[s]
        s += 1
        mx = (2 * threshold - 1) - remaining
        remaining -= abs(c)
        v = c + 1
        if v >= threshold:
            v += mx
        x |= v << bit
        bit += nbits - (v < mx)
        prev0 = c == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    return x.to_bytes((bit + 7) >> 3, "little")


# ------------------------------------------------- sequences' code tables
_LL_NORM = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2,
            2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_NORM = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_NORM = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]


def _bases(bits: list[int], first: int) -> list[int]:
    out, v = [], first
    for b in bits:
        out.append(v)
        v += 1 << b
    return out


_LL_BASE = _bases(_LL_BITS, 0)
_ML_BASE = _bases(_ML_BITS, 3)
# (max accuracy log, max code, predefined distribution, its accuracy log)
_SEQ_KINDS = {"ll": (9, 35, _LL_NORM, 6), "of": (8, 31, _OF_NORM, 5),
              "ml": (9, 52, _ML_NORM, 6)}


@functools.lru_cache(maxsize=None)
def _predefined(kind: str):
    _max_al, _max_sym, norm, al = _SEQ_KINDS[kind]
    return _fse_table(norm, al) + (al,)


# ------------------------------------------------------------------ Huffman
def _huf_weights(data, off: int, end: int):
    """A Huffman tree description (RFC 8878 4.2.1) -> (weights of every
    symbol, the last one's derived; offset after the description)."""
    if off >= end:
        raise ZstdError("truncated Huffman tree description")
    hb = data[off]
    off += 1
    if hb >= 128:
        n = hb - 127
        nbytes = (n + 1) // 2
        if off + nbytes > end:
            raise ZstdError("truncated Huffman weights")
        w = []
        for b in data[off:off + nbytes]:
            w += [b >> 4, b & 15]
        w = w[:n]
        off += nbytes
    else:
        if off + hb > end:
            raise ZstdError("truncated Huffman weights")
        norm, al, p = _read_fse_dist(data, off, off + hb, 6, 255)
        sym, nb, base = _fse_table(norm, al)
        # the stream is < 128 bytes: one int, 64 zero bits below its start
        # for the reads past it that end the decode
        pos = _Backward(data[p:off + hb]).pos + 64
        x = int.from_bytes(data[p:off + hb], "little") << 64
        mask = [(1 << n) - 1 for n in range(al + 1)]
        pos -= 2 * al
        s1, s2 = (x >> (pos + al)) & mask[al], (x >> pos) & mask[al]
        w = []
        while len(w) < 256:
            w.append(sym[s1])
            pos -= nb[s1]
            s1 = base[s1] + ((x >> pos) & mask[nb[s1]])
            if pos < 64:
                w.append(sym[s2])
                break
            w.append(sym[s2])
            pos -= nb[s2]
            s2 = base[s2] + ((x >> pos) & mask[nb[s2]])
            if pos < 64:
                w.append(sym[s1])
                break
        off += hb
    if len(w) > 255 or max(w, default=0) > HUF_MAX_BITS:
        raise ZstdError("corrupt Huffman weights")
    total = sum(1 << (x - 1) for x in w if x)
    if not total:
        raise ZstdError("Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if max_bits > HUF_MAX_BITS or rest & (rest - 1):
        raise ZstdError("Huffman weights do not make a prefix code")
    return w + [rest.bit_length()], off


def _huf_table(weights: list[int]):
    """Weights -> the decoding table over an 11-bit window: (symbol, code
    length) per window value, as uint8 arrays of 2048."""
    max_bits = (sum(1 << (x - 1) for x in weights if x)).bit_length() - 1
    w = np.asarray(weights)
    order = np.lexsort((np.arange(len(w)), w))
    order = order[w[order] > 0]
    reps = 1 << (w[order] - 1)
    sym = np.repeat(order, reps).astype(np.uint8)
    ln = np.repeat(max_bits + 1 - w[order], reps).astype(np.uint8)
    spread = 1 << (HUF_MAX_BITS - max_bits)
    return np.repeat(sym, spread), np.repeat(ln, spread)


def _huffman_decode(streams: list, tables: list, device) -> np.ndarray:
    """Every Huffman stream's symbols, concatenated in order. ``streams``:
    (bytes, table index, symbol count); ``tables``: ``_huf_table``s. The
    streams go through in batches of at most ``_BATCH_BITS`` positions,
    in torch on ``device``; on the CPU in one thread, which decodes at
    three quarters of eight threads' rate and leaves a parallel caller its
    cores."""
    if not streams:
        return np.zeros(0, np.uint8)
    dev = torch.device(device)
    syms = torch.from_numpy(np.concatenate([t[0] for t in tables])).to(dev)
    lens = torch.from_numpy(np.concatenate([t[1] for t in tables])
                            .astype(np.int32)).to(dev)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        out, batch, bits = [], [], 0
        for s in streams:
            n = 8 * len(s[0]) + 1
            if batch and bits + n > _BATCH_BITS:
                out.append(_huffman_batch(batch, syms, lens, dev))
                batch, bits = [], 0
            batch.append(s)
            bits += n
        out.append(_huffman_batch(batch, syms, lens, dev))
    finally:
        torch.set_num_threads(threads)
    return np.concatenate(out)


def _huffman_batch(batch, syms, lens, dev) -> np.ndarray:
    """One batch of ``_huffman_decode``. The streams lie one after another
    in one buffer; every bit position g of it is a node, pointing past the
    symbol whose code ends there (g less the code's length), and the chain
    from each stream's first bit is found by pointer doubling. Positions
    are int32 (a batch is below 2^31 bits)."""
    size = np.array([len(b[0]) for b in batch], np.int64)
    top = []                             # each stream's bits below its marker
    for data, _t, _n in batch:
        if not len(data) or data[-1] == 0:
            raise ZstdError("Huffman stream without its end marker")
        top.append(8 * (len(data) - 1) + data[-1].bit_length() - 1)
    nb = int(size.sum())
    n = 8 * nb
    lo = 8 * np.concatenate([[0], np.cumsum(size)[:-1]])   # first bits
    tabs = np.array([b[1] for b in batch], np.int64) * 2048
    buf = np.concatenate([np.zeros(2, np.uint8)]
                         + [np.frombuffer(b[0], np.uint8) for b in batch]
                         + [np.zeros(1, np.uint8)]).astype(np.int32)
    # per byte b: the 24 bits from b - 2, whose bits j + 5 .. j + 15 are
    # the 11-bit window below node 8b + j
    word = torch.from_numpy(buf[:nb] | (buf[1:nb + 1] << 8)
                            | (buf[2:nb + 2] << 16)).to(dev)
    tab = torch.from_numpy(np.repeat(tabs.astype(np.int32), size)).to(dev)
    j = torch.arange(5, 13, dtype=torch.int32, device=dev)
    ent = (tab[:, None] + ((word[:, None] >> j) & 0x7FF)).view(-1)
    del word, tab
    node = torch.arange(n + 1, dtype=torch.int32, device=dev)
    jump = node[:-1] - torch.index_select(lens, 0, ent)
    # a stream's first 11 bits: the window's bits below the stream are 0,
    # and no code runs past its start (node n: none)
    first = np.arange(HUF_MAX_BITS) < 8 * size[:, None]
    p, r, t = (torch.from_numpy(np.ascontiguousarray(a[first])).to(dev)
               for a in np.broadcast_arrays(lo[:, None] + np.arange(
                   HUF_MAX_BITS), np.arange(HUF_MAX_BITS), tabs[:, None]))
    below = HUF_MAX_BITS - r
    e = t + (((ent[p] - t) >> below) << below)
    ln = lens[e]
    ent[p] = e.int()
    jump[p] = torch.where((r >= ln) & (r >= 1), p - ln, n).int()
    jump = torch.cat([jump, node[-1:]])
    del node
    known = torch.from_numpy(lo + np.asarray(top, np.int64)).int().to(dev)
    while True:                          # known: the first 2^k of a chain
        new = torch.index_select(jump, 0, known)
        new = new[new != n]
        if not new.numel():
            break
        known = torch.cat([known, new])
        jump = torch.index_select(jump, 0, jump)
    del jump
    # the chain nodes by stream, each from its top: the streams' nodes in
    # descending order, then each stream's block moved to its place
    on = torch.zeros(n, dtype=torch.bool, device=dev)
    on[known.long()] = True
    pos = on.nonzero().view(-1).flip(0)
    lo = torch.from_numpy(lo).to(dev)
    sk = torch.searchsorted(lo, pos, right=True) - 1
    cnt = torch.bincount(sk, minlength=len(batch))
    ends = torch.bincount(sk[pos == lo[sk]], minlength=len(batch))
    shift = cnt.flip(0).cumsum(0).flip(0) - cnt.cumsum(0)
    pos = pos[torch.repeat_interleave(shift, cnt)
              + torch.arange(len(pos), device=dev)]
    want = np.array([b[2] for b in batch], np.int64)
    if not (np.array_equal((cnt - ends).cpu().numpy(), want)
            and (ends == 1).all()):
        raise ZstdError("corrupt Huffman stream")
    keep = pos != lo[torch.searchsorted(lo, pos, right=True) - 1]
    return syms[ent[pos[keep]].long()].cpu().numpy()


# ----------------------------------------------------------------- XXH64
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame content checksum's hash)."""
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        words = np.frombuffer(data, "<u8", count=(n // 32) * 4).tolist()
        for j in range(0, len(words), 4):
            v = [_round(v[k], words[j + k]) for k in range(4)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        p = (n // 32) * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------------------ decoder
class _FrameState:
    """What carries from block to block within a frame."""

    def __init__(self):
        self.huf = None           # index of the last Huffman table
        self.seq = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def decompress(data, max_size: int | None = None, device="cpu") -> bytes:
    """Every frame of ``data`` decoded, concatenated; skippable frames are
    skipped. ``max_size`` bounds the output (a frame's stated content size
    and its blocks are checked against it before use)."""
    data = memoryview(bytes(data))
    out = bytearray()
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if SKIPPABLE[0] <= magic <= SKIPPABLE[1]:
            if pos + 8 > len(data):
                raise ZstdError("truncated skippable frame")
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            pos += 8 + size
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        limit = None if max_size is None else max_size - len(out)
        pos = _frame(data, pos + 4, out, limit, device)
    return bytes(out)


def _frame(data, pos: int, out: bytearray, limit, device) -> int:
    if pos >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = (fhd >> 6, (fhd >> 5) & 1,
                                            (fhd >> 2) & 1, fhd & 3)
    if fhd & 8:
        raise ZstdError("reserved frame header bit set")
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if did:
        raise ZstdError(f"frame needs dictionary {did}, which this codec "
                        f"does not take")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > len(data):
        raise ZstdError("truncated frame header")
    fcs = int.from_bytes(data[pos:pos + fcs_size], "little") if fcs_size \
        else None
    if fcs_size == 2:
        fcs += 256
    pos += fcs_size
    if single:
        window = fcs
    if window > WINDOW_MAX:
        raise ZstdError(f"window of {window} bytes above {WINDOW_MAX}")
    if fcs is not None and limit is not None and fcs > limit:
        raise ZstdError(f"frame content of {fcs} bytes above the {limit} "
                        f"expected")
    block_max = min(window, BLOCK_MAX)
    st = _FrameState()
    plans, streams, tables = [], [], []
    size = 0
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 3:
            raise ZstdError("reserved block type")
        if bsize > block_max:
            raise ZstdError(f"block of {bsize} bytes above {block_max}")
        if btype == 1:
            if pos >= len(data):
                raise ZstdError("truncated RLE block")
            plans.append(("rle", data[pos], bsize))
            pos += 1
            size += bsize
        else:
            if pos + bsize > len(data):
                raise ZstdError("truncated block")
            if btype == 0:
                plans.append(("raw", data[pos:pos + bsize]))
                size += bsize
            else:
                plan = _compressed_block(data, pos, pos + bsize, st, streams,
                                         tables)
                size += plan[3]
                if plan[3] > block_max:
                    raise ZstdError("block decodes past its maximum size")
                plans.append(plan)
            pos += bsize
        if (fcs is not None and size > fcs) or (limit is not None
                                                and size > limit):
            raise ZstdError("frame decodes past its stated size")
        if last:
            break
    lits = _huffman_decode(streams, tables, device).tobytes()
    start = len(out)
    lp = 0
    for plan in plans:
        if plan[0] == "rle":
            out += bytes([plan[1]]) * plan[2]
        elif plan[0] == "raw":
            out += plan[1]
        else:
            _, lit, seqs, _size, regen = plan
            if lit is None:                       # Huffman-coded
                lit, lp = lits[lp:lp + regen], lp + regen
            _execute(out, start, lit, seqs)
    if fcs is not None and len(out) - start != fcs:
        raise ZstdError("frame content size does not match its blocks")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(out[start:]) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def _execute(out: bytearray, start: int, lit, seqs) -> None:
    """A block's literals and sequences (literal length, match length,
    offset) appended to ``out``; offsets reach back to the frame's
    start."""
    lp = 0
    for ll, ml, off in seqs:
        if lp + ll > len(lit):
            raise ZstdError("sequence takes more literals than the block has")
        out += lit[lp:lp + ll]
        lp += ll
        src = len(out) - off
        if src < start:
            raise ZstdError("match offset before the frame's start")
        if off >= ml:
            out += out[src:src + ml]
        else:
            pat = bytes(out[src:])
            out += (pat * (ml // off + 1))[:ml]
    out += lit[lp:]


def _compressed_block(data, pos, end, st, streams, tables):
    """Parse one compressed block -> ("cmp", literals or None when they are
    Huffman-coded (queued on ``streams``), sequences, decoded size,
    literals' size)."""
    b0 = data[pos]
    ltype, sf = b0 & 3, (b0 >> 2) & 3
    if ltype in (0, 1):
        hlen = (1, 2, 1, 3)[sf]
        if pos + hlen > end:
            raise ZstdError("truncated literals header")
        h = int.from_bytes(data[pos:pos + hlen], "little")
        regen = h >> 3 if hlen == 1 else h >> 4
        pos += hlen
        if regen > BLOCK_MAX:
            raise ZstdError("literals above the block maximum")
        if ltype == 0:
            if pos + regen > end:
                raise ZstdError("truncated raw literals")
            lit = bytes(data[pos:pos + regen])
            pos += regen
        else:
            if pos >= end:
                raise ZstdError("truncated RLE literals")
            lit = bytes([data[pos]]) * regen
            pos += 1
    else:
        hlen, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[sf]
        if pos + hlen > end:
            raise ZstdError("truncated literals header")
        h = int.from_bytes(data[pos:pos + hlen], "little")
        regen = (h >> 4) & ((1 << bits) - 1)
        csize = h >> (4 + bits)
        pos += hlen
        if regen > BLOCK_MAX or pos + csize > end:
            raise ZstdError("literals section runs past its block")
        lend = pos + csize
        p = pos
        if ltype == 2:
            weights, p = _huf_weights(data, p, lend)
            tables.append(_huf_table(weights))
            st.huf = len(tables) - 1
        elif st.huf is None:
            raise ZstdError("treeless literals with no earlier Huffman table")
        if sf == 0:
            if not regen:
                raise ZstdError("empty Huffman literals")
            streams.append((bytes(data[p:lend]), st.huf, regen))
        else:
            if p + 6 > lend:
                raise ZstdError("truncated Huffman jump table")
            s1, s2, s3 = (int.from_bytes(data[p + 2 * k:p + 2 * k + 2],
                                         "little") for k in range(3))
            p += 6
            seg = (regen + 3) // 4
            counts = (seg, seg, seg, regen - 3 * seg)
            if counts[3] < 0 or p + s1 + s2 + s3 > lend:
                raise ZstdError("corrupt Huffman jump table")
            for sz, cnt in zip((s1, s2, s3, lend - p - s1 - s2 - s3), counts):
                streams.append((bytes(data[p:p + sz]), st.huf, cnt))
                p += sz
        lit = None
        pos = lend
    seqs = _sequences(data, pos, end, st)
    if sum(s[0] for s in seqs) > regen:
        raise ZstdError("sequences take more literals than the block has")
    return ("cmp", lit, seqs, regen + sum(s[1] for s in seqs), regen)


def _sequences(data, pos, end, st) -> list:
    """The block's sequences (literal length, match length, offset), the
    repeat offsets resolved."""
    if pos >= end:
        raise ZstdError("truncated sequences section")
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("bytes after an empty sequences section")
        return []
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= end:
        raise ZstdError("truncated sequences section")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved sequence mode bits set")
    tabs = {}
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = (modes >> shift) & 3
        max_al, max_sym, _norm, _al = _SEQ_KINDS[kind]
        if mode == 0:
            tab = _predefined(kind)
        elif mode == 1:
            if pos >= end or data[pos] > max_sym:
                raise ZstdError("bad RLE sequence code")
            tab = ([data[pos]], [0], [0], 0)
            pos += 1
        elif mode == 2:
            norm, al, pos = _read_fse_dist(data, pos, end, max_al, max_sym)
            tab = _fse_table(norm, al) + (al,)
        else:
            tab = st.seq[kind]
            if tab is None:
                raise ZstdError("repeat sequence table with no earlier one")
        st.seq[kind] = tabs[kind] = tab
    (lls, llnb, llb, llal), (ofs, ofnb, ofb, ofal), (mls, mlnb, mlb, mlal) = (
        tabs["ll"], tabs["of"], tabs["ml"])
    br = _Backward(data[pos:end])
    sl, so, sm = br.read(llal), br.read(ofal), br.read(mlal)
    rep = st.rep
    seqs = []
    for k in range(nseq):
        oc, mc, lc = ofs[so], mls[sm], lls[sl]
        if oc > 31:
            raise ZstdError("offset code above 31")
        ov = (1 << oc) + br.read(oc)
        ml = _ML_BASE[mc] + br.read(_ML_BITS[mc])
        ll = _LL_BASE[lc] + br.read(_LL_BITS[lc])
        if ov > 3:
            off = ov - 3
            rep = [off, rep[0], rep[1]]
        else:
            idx = ov if ll else ov + 1        # the literal-length-0 rule
            if idx == 1:
                off = rep[0]
            elif idx == 2:
                off = rep[1]
                rep = [off, rep[0], rep[2]]
            else:
                off = rep[2] if idx == 3 else rep[0] - 1
                if off == 0:
                    raise ZstdError("repeat offset of 0")
                rep = [off, rep[0], rep[1]]
        seqs.append((ll, ml, off))
        if k != nseq - 1:
            sl = llb[sl] + br.read(llnb[sl])
            sm = mlb[sm] + br.read(mlnb[sm])
            so = ofb[so] + br.read(ofnb[so])
        if br.pos < 0:
            raise ZstdError("sequences run past their bit stream")
    if br.pos != 0:
        raise ZstdError("sequences do not consume their bit stream")
    st.rep = rep
    return seqs


# ------------------------------------------------------------------ encoder
def compress(data) -> bytes:
    """One zstd frame of ``data`` (see the module docstring)."""
    buf = np.frombuffer(bytes(data), np.uint8)
    n = len(buf)
    if n < 256:
        fhd, fcs = 0x20, n.to_bytes(1, "little")
    elif n < 65536 + 256:
        fhd, fcs = 0x60, (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        fhd, fcs = 0xA0, n.to_bytes(4, "little")
    else:
        fhd, fcs = 0xE0, n.to_bytes(8, "little")
    out = [MAGIC.to_bytes(4, "little"), bytes([fhd]), fcs]
    starts = list(range(0, n, BLOCK_MAX)) or [0]
    for i, s in enumerate(starts):
        out.append(_block(buf[s:s + BLOCK_MAX], i == len(starts) - 1))
    return b"".join(out)


def _block_header(last: bool, btype: int, size: int) -> bytes:
    return (int(last) | (btype << 1) | (size << 3)).to_bytes(3, "little")


def _block(b: np.ndarray, last: bool) -> bytes:
    """An RLE block, a block of Huffman-coded literals (four streams, or
    one below 1 KiB) or a raw block where that does not shrink ``b``."""
    if len(b) and (b == b[0]).all():
        return _block_header(last, 1, len(b)) + bytes([int(b[0])])
    table = _huffman_table(b) if len(b) > 1 else None
    body = None
    if table is not None:
        desc, code, lengths = table
        n = len(b)
        seg = (n + 3) // 4
        cuts = [0, n] if n < 1024 else [0, seg, 2 * seg, 3 * seg, n]
        body = _literals_section(n, desc, _huffman_streams(
            [(b[x:y], code, lengths) for x, y in zip(cuts, cuts[1:])]))
    if body is None or len(body) + 1 >= len(b):
        return _block_header(last, 0, len(b)) + b.tobytes()
    return _block_header(last, 2, len(body) + 1) + body + b"\x00"


def _code_lengths(counts: np.ndarray) -> np.ndarray:
    """Huffman code lengths of at most ``HUF_MAX_BITS`` for the symbols
    with counts (flattening the counts until the longest code fits): the
    two-queue construction over the counts in ascending order."""
    c = counts.astype(np.int64)
    while True:
        syms = np.flatnonzero(c)
        syms = syms[np.argsort(c[syms], kind="stable")]
        m = len(syms)
        w = c[syms].tolist() + [0] * (m - 1)
        parent = [0] * (2 * m - 1)
        leaf, node = 0, m               # the next leaf, the next inner node
        for new in range(m, 2 * m - 1):
            for _ in range(2):          # the smaller front of the two queues
                if leaf < m and (node >= new or w[leaf] <= w[node]):
                    pick, leaf = leaf, leaf + 1
                else:
                    pick, node = node, node + 1
                parent[pick] = new
                w[new] += w[pick]
        depth = [0] * (2 * m - 1)
        for x in range(2 * m - 3, -1, -1):
            depth[x] = depth[parent[x]] + 1
        lengths = np.zeros(len(c), np.int64)
        lengths[syms] = depth[:m]
        if lengths.max() <= HUF_MAX_BITS:
            return lengths
        c = np.where(c > 0, (c + 1) // 2, 0)


def _fse_weights(w: list[int]) -> bytes | None:
    """Huffman weights FSE-coded with two interleaved states (the inverse
    of ``_huf_weights``'s decoder), or None where FSE cannot code them."""
    hist = np.bincount(w, minlength=HUF_MAX_BITS + 1)
    if np.count_nonzero(hist) < 2:
        return None
    al = 6
    norm = np.where(hist > 0, np.maximum(1, np.rint(hist * 64 / len(w))),
                    0).astype(int)
    big = int(np.argmax(hist))
    norm[big] += 64 - norm.sum()
    while norm[big] < 1:          # rounding took too much from the largest
        k = int(np.argmax(np.where(np.arange(len(norm)) == big, 0, norm)))
        norm[k] -= 1
        norm[big] += 1
    norm = norm[:int(np.flatnonzero(norm).max()) + 1].tolist()
    sym, nb, base = _fse_table(norm, al)
    enc = {}
    for t, s in enumerate(sym):
        for x in range(base[t], base[t] + (1 << nb[t])):
            enc[(s, x)] = t

    def widest(s):
        return max((t for t in range(64) if sym[t] == s), key=lambda t: nb[t])
    n = len(w)
    state = [0] * n
    state[n - 1], state[n - 2] = widest(w[n - 1]), widest(w[n - 2])
    reads = []
    for k in range(n - 3, -1, -1):
        x = state[k + 2]
        t = enc[(w[k], x)]
        state[k] = t
        reads.append((x - base[t], nb[t]))
    reads += [(state[1], al), (state[0], al)]      # the first two read
    x, bit = 0, 0
    for v, nbits in reads:                          # last read at bit 0
        x |= v << bit
        bit += nbits
    x |= 1 << bit
    return _write_fse_dist(norm, al) + x.to_bytes(bit // 8 + 1, "little")


def _huffman_table(b: np.ndarray):
    """(tree description, code and length per byte value) of a Huffman
    code for ``b``, or None where its weights cannot be described."""
    counts = np.bincount(b, minlength=256)
    lengths = _code_lengths(counts)
    max_bits = int(lengths.max())
    last = int(np.flatnonzero(counts).max())
    weights = np.where(lengths > 0, max_bits + 1 - lengths, 0)
    w = weights[:last].tolist()
    desc = None
    fse = _fse_weights(w) if len(w) >= 2 else None
    if fse is not None and len(fse) < 128:
        desc = bytes([len(fse)]) + fse
    if len(w) <= 128:
        nib = w + [0] * (len(w) & 1)
        direct = bytes([127 + len(w)]) + bytes(
            (nib[k] << 4) | nib[k + 1] for k in range(0, len(nib), 2))
        if desc is None or len(direct) < len(desc):
            desc = direct
    if desc is None:
        return None
    # canonical codes: by weight, then symbol, from 0 (RFC 8878 4.2.1.3)
    order = np.lexsort((np.arange(256), weights))
    order = order[weights[order] > 0]
    span = 1 << (weights[order] - 1)
    first = np.concatenate([[0], np.cumsum(span)[:-1]])
    code = np.zeros(256, np.int64)
    code[order] = first >> (weights[order] - 1)
    return desc, code, lengths


def _literals_section(n: int, desc: bytes, streams: list) -> bytes | None:
    """A compressed literals section of ``n`` literals from its tree
    description and its one or four streams, or None where its sizes do
    not fit the header."""
    if len(streams) == 1:
        payload = desc + streams[0]
        sf, hlen, bits = 0, 3, 10
    else:
        if max(len(s) for s in streams[:3]) > 0xFFFF:
            return None
        payload = desc + b"".join(len(s).to_bytes(2, "little")
                                  for s in streams[:3]) + b"".join(streams)
        size = max(n, len(payload))
        sf, hlen, bits = ((1, 3, 10) if size < 1024 else (2, 4, 14)
                          if size < 16384 else (3, 5, 18))
    if len(payload) >= 1 << bits:
        return None
    h = 2 | (sf << 2) | (n << 4) | (len(payload) << (4 + bits))
    return h.to_bytes(hlen, "little") + payload


def _huffman_streams(parts: list) -> list[bytes]:
    """Huffman streams, one for each (symbols, code, lengths): in each the
    first symbol in the highest bits, the end marker above it. The codes
    are looked up by table, their bit offsets a cumulative sum taken from
    the stream's end, and the bytes made by one scatter-add (the codes'
    bits do not overlap); a stream at a time, which its arrays' few
    hundred KiB keep in cache."""
    out = []
    for sym, code, lengths in parts:
        s = sym[::-1]
        ln = lengths[s]
        off = np.cumsum(ln) - ln
        total = int(off[-1] + ln[-1])
        nbytes = total // 8 + 1
        v = code[s] << (off & 7)
        i = off >> 3
        acc = np.zeros(nbytes + 2, np.int64)
        for k in range(3):
            acc += np.bincount(i + k, weights=(v >> (8 * k)) & 255,
                               minlength=nbytes + 2).astype(np.int64)
        acc[total >> 3] += 1 << (total & 7)
        out.append(acc[:nbytes].astype(np.uint8).tobytes())
    return out
