"""The port's Zstandard codec (``tpusr_torch/train/zstd.py``) against the
``zstandard`` package, on the CPU.

- frames that ``zstandard`` writes at levels -5, 1, 3 and 19 from seeded
  float32 weights, zeros, text-like and random bytes decode equal byte for
  byte, as do frames over 128 KiB, several frames in a row, skippable
  frames, one-stream literals and checksummed frames;
- the vectorised Huffman decoder equals a symbol-by-symbol reference;
- the encoder's frames decompress with ``zstandard`` to their input;
- truncated and corrupt frames, a dictionary and an oversized window raise
  naming what is wrong.
"""

import numpy as np
import pytest

from tpusr_torch.train import zstd

zstandard = pytest.importorskip("zstandard")

LEVELS = (-5, 1, 3, 19)


def _data(kind: str, n: int = 140_000) -> bytes:
    rng = np.random.default_rng({"weights": 0, "zeros": 1, "text": 2,
                                 "random": 3, "moments": 4}[kind])
    if kind == "weights":
        return (rng.standard_normal(n // 4) * 0.05).astype(np.float32).tobytes()
    if kind == "moments":      # Adam's nu: small positive squares
        return ((rng.standard_normal(n // 4) * 1e-3) ** 2).astype(
            np.float32).tobytes()
    if kind == "zeros":
        return bytes(n)
    if kind == "text":
        words = [b"alpha", b"beta", b"gamma", b"kernel", b"bias", b"conv",
                 b"block", b"res", b"\n", b" ", b"0.125", b"{", b"}"]
        idx = rng.integers(0, len(words), n // 4)
        return b"".join(words[i] for i in idx)[:n]
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


KINDS = ("weights", "moments", "zeros", "text", "random")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_equals_zstandard(kind, level):
    data = _data(kind)
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame, max_size=len(data)) == data


def test_frames_in_a_row_skippable_frames_and_checksums():
    parts = [_data("text", 5000), _data("weights", 200_000), b"", b"x"]
    c = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skip = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") \
        + b"7 bytes"
    stream = skip + b"".join(c.compress(p) for p in parts) + skip
    assert zstd.decompress(stream) == b"".join(parts)


def test_frames_without_a_content_size_and_streamed_blocks():
    data = _data("weights", 400_000)
    obj = zstandard.ZstdCompressor(level=1,
                                   write_content_size=False).compressobj()
    frame = obj.compress(data) + obj.flush()
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("n", (40, 300, 1000))
def test_one_stream_literals(n):
    """Below 1 KiB of literals a block's Huffman literals are one stream."""
    data = _data("text", n)
    frame = zstandard.ZstdCompressor(level=19).compress(data)
    assert zstd.decompress(frame) == data


def _reference_huffman(stream: bytes, table, count: int) -> bytes:
    """Symbol by symbol: peek 11 bits from the top, emit, drop the code."""
    sym, ln = table
    x = int.from_bytes(stream, "little")
    pos = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
    out = bytearray()
    for _ in range(count):
        w = (x << 11 >> pos) & 0x7FF if pos < 11 else (x >> (pos - 11)) & 0x7FF
        out.append(int(sym[w]))
        pos -= int(ln[w])
    assert pos == 0
    return bytes(out)


def _literals(block: np.ndarray) -> bytes:
    """The encoder's compressed literals section of one block (4 streams)."""
    desc, code, lengths = zstd._huffman_table(block)
    n = len(block)
    seg = (n + 3) // 4
    cuts = [0, seg, 2 * seg, 3 * seg, n]
    streams = zstd._huffman_streams([(block[x:y], code, lengths)
                                     for x, y in zip(cuts, cuts[1:])])
    return zstd._literals_section(n, desc, streams)


def test_vectorised_huffman_equals_a_symbol_by_symbol_decode():
    data = _data("weights", 100_000)
    block = np.frombuffer(data[:60_000], np.uint8)
    lit = _literals(block)
    # parse the section the encoder wrote: its header, table, jump table
    h = int.from_bytes(lit[:5], "little")
    weights, p = zstd._huf_weights(lit, 5, len(lit))
    table = zstd._huf_table(weights)
    sizes = [int.from_bytes(lit[p + 2 * k:p + 2 * k + 2], "little")
             for k in range(3)]
    p += 6
    sizes.append(len(lit) - p - sum(sizes))
    seg = (60_000 + 3) // 4
    counts = (seg, seg, seg, 60_000 - 3 * seg)
    streams = []
    for sz, cnt in zip(sizes, counts):
        streams.append((lit[p:p + sz], 0, cnt))
        p += sz
    assert (h >> 4) & ((1 << 18) - 1) == 60_000
    got = zstd._huffman_decode(streams, [table], "cpu").tobytes()
    want = b"".join(_reference_huffman(s, table, c) for s, _t, c in streams)
    assert got == want == block.tobytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", (0, 1, 700, 1 << 17, (1 << 17) + 1))
def test_encoder_frames_decompress_with_zstandard(kind, n):
    data = _data(kind, n)
    frame = zstd.compress(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    if kind == "zeros" and n > 1000:
        assert len(frame) < 16 + 4 * (n // (1 << 17) + 1)   # RLE blocks
    if kind in ("weights", "text") and n > 1000:
        assert len(frame) < 0.95 * n                        # Huffman coded


def test_truncated_frames_raise():
    data = _data("weights", 200_000)
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    for cut in (1, 4, 5, 7, 12, 100, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])


def test_corrupt_frames_raise_naming_what_is_wrong():
    data = _data("weights", 100_000)
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(bad))
    bad = bytearray(frame)
    bad[0] ^= 1
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError, match="above the 100 expected"):
        zstd.decompress(bytes(frame), max_size=100)
    ours = bytearray(zstd.compress(data))          # fhd 0xA0: 4-byte size
    bad = bytearray(ours)
    bad[5:9] = (len(data) + 1).to_bytes(4, "little")
    with pytest.raises(zstd.ZstdError, match="size"):
        zstd.decompress(bytes(bad))
    bad = bytearray(ours)
    bad[9] |= 0x06                                  # reserved block type
    with pytest.raises(zstd.ZstdError, match="reserved block type"):
        zstd.decompress(bytes(bad))


def test_a_dictionary_and_an_oversized_window_are_refused():
    ours = zstd.compress(b"hello hello hello")       # single segment, 1B size
    with_dict = ours[:4] + bytes([ours[4] | 1, 9]) + ours[5:]
    with pytest.raises(zstd.ZstdError, match="dictionary 9"):
        zstd.decompress(with_dict)
    huge = ours[:4] + bytes([0x00, (22 << 3)]) + ours[6:]
    with pytest.raises(zstd.ZstdError, match="window"):
        zstd.decompress(huge)
