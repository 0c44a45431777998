"""GIF through the port's decoder (``pipeline/gif.py``) against
``cv2.imdecode(IMREAD_COLOR)`` byte for byte: Pillow's files in every mode,
files written by hand (``write_gif``) for the global, local and missing
colour tables, transparency on an offset frame, interlace, animation, the
LZW code growth, a table that fills, the end code mid-stream, and what
OpenCV 5's own decoder refuses (a cut file, a missing trailer, an index or
background past the table, a frame off its screen, too few or too many
pixels), refused where cv2 returns nothing.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_image_writers import gif_sub_blocks, write_gif
from tpusr_torch.pipeline import imdecode

RNG = np.random.default_rng(20)
PAL = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
IDX = RNG.integers(0, 256, (10, 12))
IDX16 = RNG.integers(0, 16, (9, 11))


def _held_to_cv2(body: bytes):
    """Equal to cv2's decode, or refused where cv2 returns nothing."""
    want = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if want is None:
        with pytest.raises(ValueError):
            imdecode.decode_image_u8(body)
    else:
        np.testing.assert_array_equal(imdecode.decode_image_u8(body),
                                      want[..., ::-1])
    return want


def _codes(codes) -> bytes:
    """(code, width) pairs packed least significant bit first."""
    acc = n = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << n
        n += width
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8
    return bytes(out + (bytes([acc]) if n else b""))


def _raw_gif(data: bytes, w: int, h: int, min_size=8) -> bytes:
    return (b"GIF89a" + struct.pack("<HH", w, h) + bytes([0xF7, 9, 0])
            + PAL.tobytes() + b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
            + bytes([min_size]) + gif_sub_blocks(data) + b"\x3b")


def _with_extension(ext: bytes) -> bytes:
    """A global-table GIF with ``ext`` before its image descriptor."""
    body = write_gif([dict(idx=IDX)], 12, 10, PAL)
    return body[:13 + 768] + ext + body[13 + 768:]


CLEAR, END = 256, 257
LITS = [(CLEAR, 9), (5, 9), (6, 9), (7, 9), (8, 9)]
CASES = {
    "global": (write_gif([dict(idx=IDX)], 12, 10, PAL), True),
    "offset-frame-on-background": (write_gif([dict(idx=IDX, x=3, y=2)], 20,
                                             15, PAL, background=5), True),
    "transparent": (write_gif([dict(idx=IDX, transparent=int(IDX[0, 0]),
                                    x=1, y=1)], 14, 12, PAL, background=5),
                    True),
    "transparent-no-global": (write_gif([dict(
        idx=IDX16, palette=PAL[:16], transparent=3, min_size=4)], 11, 9,
        None, background=3), True),
    "interlace": (write_gif([dict(idx=RNG.integers(0, 256, (19, 7)),
                                  interlace=True)], 7, 19, PAL), True),
    "local": (write_gif([dict(idx=IDX16, palette=PAL[40:56], min_size=4)],
                        11, 9, PAL), True),
    "local-smaller-than-global": (write_gif([dict(
        idx=IDX16, palette=PAL[40:44], min_size=4)], 11, 9, PAL), True),
    "no-tables": (write_gif([dict(idx=IDX)], 12, 10, None), True),
    "animation": (write_gif([dict(idx=IDX[:6, :8], x=2, y=3),
                             dict(idx=IDX, disposal=2)], 12, 10, PAL,
                            background=7, loop=True), True),
    "gif87a": (write_gif([dict(idx=IDX)], 12, 10, PAL, version=b"87a"), True),
    "table-fills": (write_gif([dict(idx=RNG.integers(0, 256, (64, 64)))],
                              64, 64, PAL), True),
    "code-growth": (write_gif([dict(idx=(RNG.integers(0, 4, (40, 200))
                                         + np.arange(200) // 10) % 256)],
                              200, 40, PAL), True),
    "min-code-size-2": (write_gif([dict(idx=RNG.integers(0, 4, (6, 5)),
                                        min_size=2)], 5, 6, PAL[:4]), True),
    "end-code-mid-stream": (_raw_gif(_codes(
        [(CLEAR, 9), (5, 9), (END, 9), (6, 9), (258, 9)]), 2, 2), True),
    "no-end-code": (_raw_gif(_codes(LITS), 2, 2), True),
    "clear-mid-stream": (_raw_gif(_codes(
        [(CLEAR, 9), (5, 9), (6, 9), (CLEAR, 9), (7, 9), (8, 9)]), 2, 2),
        True),
    "kwkwk": (_raw_gif(_codes([(CLEAR, 9), (5, 9), (258, 9), (7, 9)]), 2, 2),
              True),
    # once the frame is full, clear and end codes aside, only the data's
    # last whole code may follow, whatever it is
    "full-then-last-literal": (_raw_gif(_codes(LITS + [(9, 9)]), 2, 2), True),
    "full-then-end-then-literal": (_raw_gif(_codes(
        LITS + [(END, 9), (9, 9)]), 2, 2), True),
    "full-then-bad-code-last": (_raw_gif(_codes(LITS + [(511, 9)]), 2, 2),
                                True),
    "full-then-end-and-zero-bytes": (_raw_gif(_codes(LITS + [(END, 9)])
                                              + b"\0\0", 2, 2), False),
    "unknown-application-extension": (write_gif(
        [dict(idx=IDX)], 12, 10, PAL, loop=True).replace(
            b"NETSCAPE2.0", b"ANIMEXTS1.0"), False),
    "graphic-control-of-5-bytes": (_with_extension(
        b"\x21\xf9\x05\x01\x0a\x00\x03\x00\x00"), False),
    "comment-and-plain-text": (_with_extension(
        b"\x21\xfe\x05hello\x00\x21\x01\x0c" + bytes(12) + b"\x02hi\x00"),
        True),
    # refused
    "index-past-tables": (write_gif([dict(idx=IDX16, palette=PAL[:4],
                                          min_size=4)], 11, 9, PAL[:4]),
                          False),
    "background-past-table": (write_gif([dict(idx=IDX16[:, :4] % 4,
                                              min_size=2)], 4, 9, PAL[:4],
                                        background=7), False),
    "frame-off-screen": (write_gif([dict(idx=IDX, x=3)], 12, 10, PAL), False),
    "too-few-pixels": (_raw_gif(_codes(LITS[:4] + [(END, 9)]), 2, 2), False),
    "too-many-pixels": (_raw_gif(_codes(LITS + [(9, 9), (END, 9)]), 2, 2),
                        False),
    "code-past-table": (_raw_gif(_codes([(CLEAR, 9), (5, 9), (260, 9)]), 2,
                                 2), False),
    "min-code-size-12": (_raw_gif(_codes([(4096, 13)]), 2, 2, 12), False),
    "no-trailer": (write_gif([dict(idx=IDX)], 12, 10, PAL)[:-1], False),
    "cut": (write_gif([dict(idx=IDX)], 12, 10, PAL)[:200], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_written_gif(case):
    body, decodes = CASES[case]
    assert (_held_to_cv2(body) is not None) == decodes


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pillow_gif(mode):
    rng = np.random.default_rng(len(mode))
    img = Image.fromarray(rng.integers(0, 256, (33, 27, 3), np.uint8))
    if mode == "RGBA":
        img = img.convert("RGBA")
        img.putalpha(Image.fromarray((rng.random((33, 27)) > 0.3)
                                     .astype(np.uint8) * 255))
    else:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "GIF")
    assert _held_to_cv2(buf.getvalue()) is not None


def test_pillow_animation_first_frame():
    rng = np.random.default_rng(3)
    frames = [Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8))
              for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   duration=40, loop=0, disposal=2)
    assert _held_to_cv2(buf.getvalue()) is not None


def test_expected_size_is_refused_before_decoding():
    body = write_gif([dict(idx=IDX)], 12, 10, PAL)
    with pytest.raises(ValueError, match="expected"):
        imdecode.decode_image_u8(body, expected_hw=(12, 10))
