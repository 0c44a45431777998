"""The port's PNG decoder (``tpusr_torch/pipeline/png.py``) on what libpng
reads beyond 8- and 16-bit non-interlaced PNG: Adam7 interlacing at every
colour type and bit depth, gray and palette at 1, 2 and 4 bits, ``tRNS``,
a palette index past its PLTE, the eXIf orientation. Held against
``cv2.imdecode(IMREAD_COLOR)`` swapped to RGB, with no tolerance, on files
written by ``tests/torch_image_writers.py``.
"""

import struct

import cv2
import numpy as np
import pytest

from torch_image_writers import png_chunk, write_png
from tpusr_torch.pipeline import imdecode, png

# colour type -> (channels, bit depths the format allows)
COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
               4: (2, (8, 16)), 6: (4, (8, 16))}
CASES = [(c, d) for c, (_, depths) in COLOR_TYPES.items() for d in depths]


def _cv2_rgb(body: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return bgr[..., ::-1]


def _image(rng, h, w, color, depth):
    ch = COLOR_TYPES[color][0]
    s = rng.integers(0, 1 << depth, (h, w, ch))
    return s.astype(np.uint16 if depth == 16 else np.uint8)


def _body(rng, h, w, color, depth, interlace):
    pal = rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None
    return write_png(_image(rng, h, w, color, depth), depth, color,
                     interlace=interlace, palette=pal)


@pytest.mark.parametrize("color,depth", CASES)
def test_adam7_equals_cv2_at_every_colour_type_and_depth(color, depth):
    """Every pass present and some empty (1x1, 3x5), passes of odd widths,
    rows filtered with Sub at 8 and 16 bits."""
    rng = np.random.default_rng(10 * color + depth)
    for h, w in ((1, 1), (3, 5), (9, 17), (17, 9), (8, 8)):
        body = _body(rng, h, w, color, depth, interlace=1)
        got = png.decode_png_u8(body)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _cv2_rgb(body))


@pytest.mark.parametrize("color,depth", [c for c in CASES if c[1] < 8])
def test_low_depths_equal_cv2_without_interlace(color, depth):
    """Rows padded to a byte; gray scaled as
    ``png_set_expand_gray_1_2_4_to_8`` scales it."""
    rng = np.random.default_rng(depth)
    for h, w in ((1, 1), (5, 13), (7, 3)):
        body = _body(rng, h, w, color, depth, interlace=0)
        np.testing.assert_array_equal(png.decode_png_u8(body), _cv2_rgb(body))


def test_trns_is_dropped_as_cv2_drops_it():
    rng = np.random.default_rng(5)
    cases = [(0, 8, struct.pack(">H", 7)), (2, 8, struct.pack(">HHH", 1, 2, 3)),
             (2, 16, struct.pack(">HHH", 1, 2, 3)), (0, 2, struct.pack(">H", 1)),
             (3, 4, bytes([0, 128, 255]))]
    for color, depth, trns in cases:
        img = _image(rng, 6, 7, color, depth)
        pal = rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None
        body = write_png(img, depth, color, palette=pal,
                         chunks=[(b"tRNS", trns)])
        np.testing.assert_array_equal(png.decode_png_u8(body), _cv2_rgb(body))


def test_a_palette_index_past_the_plte_reads_as_black():
    idx = np.array([[[0], [1], [2], [5]]], np.uint8)
    body = write_png(idx, 8, 3, palette=[[9, 8, 7], [6, 5, 4], [3, 2, 1]])
    got = png.decode_png_u8(body)
    np.testing.assert_array_equal(got, _cv2_rgb(body))
    assert got[0, 3].tolist() == [0, 0, 0]


def _exif(orientation: int, order: str) -> bytes:
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_as_cv2_applies_it(orientation):
    rng = np.random.default_rng(orientation)
    img = rng.integers(0, 256, (4, 7, 3)).astype(np.uint8)
    for order in ("II", "MM"):
        body = write_png(img, 8, 2, chunks=[(b"eXIf", _exif(orientation,
                                                            order))])
        got = png.decode_png_u8(body)
        assert got.shape[:2] == ((7, 4) if orientation >= 5 else (4, 7))
        np.testing.assert_array_equal(got, _cv2_rgb(body))
    # after IDAT too: cv2 reads the whole file before it turns the image
    plain = write_png(img, 8, 2)
    end = plain.rindex(b"IEND") - 4
    body = plain[:end] + png_chunk(b"eXIf", _exif(orientation, "II")) \
        + plain[end:]
    np.testing.assert_array_equal(png.decode_png_u8(body), _cv2_rgb(body))


def test_expected_size_refuses_before_inflating(monkeypatch):
    rng = np.random.default_rng(2)
    body = _body(rng, 16, 24, 2, 8, interlace=1)
    monkeypatch.setattr(png.zlib, "decompressobj",
                        lambda: (_ for _ in ()).throw(AssertionError("inflated")))
    with pytest.raises(ValueError, match="expected 8x8 LR input"):
        imdecode.decode_image_u8(body, expected_hw=(8, 8))
    monkeypatch.undo()
    # an eXIf turn may bring a transposed frame to the size
    turned = write_png(_image(rng, 16, 24, 2, 8), 8, 2,
                       chunks=[(b"eXIf", _exif(6, "II"))])
    got = imdecode.decode_image_u8(turned, expected_hw=(24, 16))
    np.testing.assert_array_equal(got, _cv2_rgb(turned))


def test_truncated_interlaced_data_is_refused():
    rng = np.random.default_rng(3)
    body = _body(rng, 9, 17, 2, 8, interlace=1)
    i = body.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", body[i:i + 4])
    data = body[i + 8:i + 8 + n]
    import zlib
    short = zlib.compress(zlib.decompress(data)[:-5])
    cut = body[:i] + png_chunk(b"IDAT", short) + png_chunk(b"IEND", b"")
    assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="truncated PNG data"):
        png.decode_png_u8(cut)
