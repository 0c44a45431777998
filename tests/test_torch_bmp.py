"""The port's BMP decoder (``tpusr_torch/pipeline/bmp.py``) against
``cv2.imdecode(IMREAD_COLOR)`` swapped to RGB, with no tolerance: the
files OpenCV and Pillow write (1, 8, 24 and 32 bpp, gray and palette),
and hand-built ones (``tests/torch_image_writers.py``) for 4 bpp, 16 bpp
5-5-5 and 5-6-5, bit-field masks, OS/2 v1 and v4/v5 headers, top-down rows
and OpenCV's RLE8/RLE4 state machine with its end-of-line, end-of-bitmap
and delta escapes. What OpenCV refuses, the decoder refuses; a crafted
header is refused before memory is sized from it.
"""

import io
import tracemalloc

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_image_writers import bmp_rows, rgbq, write_bmp
from tpusr_torch.pipeline import bmp, imdecode


def _cv2_rgb(body: bytes):
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _same(body: bytes):
    want = _cv2_rgb(body)
    assert want is not None
    got = bmp.decode_bmp_u8(body)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _refused_as_cv2(body: bytes, what: str):
    assert _cv2_rgb(body) is None
    with pytest.raises(ValueError, match=what):
        bmp.decode_bmp_u8(body)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pil_written_bmps_equal_cv2(mode):
    rng = np.random.default_rng(len(mode))
    img = rng.integers(0, 256, (13, 11, 3)).astype(np.uint8)
    im = Image.fromarray(img)
    im = (im.convert("P", palette=Image.ADAPTIVE, colors=13) if mode == "P"
          else im.convert(mode))
    buf = io.BytesIO()
    im.save(buf, "BMP")
    _same(buf.getvalue())


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_written_bmps_equal_cv2(channels):
    rng = np.random.default_rng(channels)
    for h, w in ((1, 1), (7, 5), (16, 33)):
        img = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
        ok, buf = cv2.imencode(".bmp", img[..., 0] if channels == 1 else img)
        assert ok
        _same(buf.tobytes())


@pytest.mark.parametrize("header", [12, 40, 108, 124])
@pytest.mark.parametrize("bpp", [1, 4, 8, 24, 32])
def test_every_header_and_depth_equals_cv2(header, bpp):
    """Palettes of 2^bpp entries (3-byte ones under OS/2 v1), a width that
    is not a whole number of bytes, 4-byte row padding."""
    rng = np.random.default_rng(header + bpp)
    w, h = 13, 6
    pal = rng.integers(0, 256, (1 << min(bpp, 8), 3)) if bpp <= 8 else None
    if bpp <= 8:
        rows = bmp_rows(rng.integers(0, 1 << bpp, (h, w)), bpp)
        palette = (pal[:, ::-1].astype(np.uint8).tobytes() if header == 12
                   else rgbq(pal))
    else:
        rows = bmp_rows(rng.integers(0, 256, (h, w, bpp // 8)).astype(
            np.uint8).reshape(h, -1), 8)
        palette = b""
    _same(write_bmp(w, h, bpp, rows, palette=palette, header=header))


def test_a_short_palette_and_an_index_past_it_read_as_black():
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (3, 3))
    rows = bmp_rows(rng.integers(0, 6, (5, 7)), 8)
    body = write_bmp(7, 5, 8, rows, palette=rgbq(pal), clr_used=3)
    _same(body)
    assert (bmp.decode_bmp_u8(body) == 0).all(-1).any()


@pytest.mark.parametrize("masks,bpp", [(None, 16), ((0x7C00, 0x3E0, 0x1F), 16),
                                       ((0xF800, 0x7E0, 0x1F), 16),
                                       ((0xFF0000, 0xFF00, 0xFF), 32),
                                       ((0xFF, 0xFF00, 0xFF0000), 32)])
def test_16_and_32_bpp_expand_as_opencv_expands_them(masks, bpp):
    """5-5-5 and 5-6-5 shifted to the top of each byte (no replication of
    the high bits), against every 16-bit value; 32 bpp reads B, G, R
    whatever its masks."""
    if bpp == 16:
        t = np.arange(1 << 16, dtype="<u2").reshape(256, 256)
        rows = t.view(np.uint8).reshape(256, 512).tobytes()
        w, h = 256, 256
    else:
        w, h = 7, 5
        rows = np.random.default_rng(4).integers(0, 256, (h, w * 4)).astype(
            np.uint8).tobytes()
    _same(write_bmp(w, h, bpp, rows, 0 if masks is None else 3, masks=masks))


def test_top_down_rows_equal_cv2():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    _same(write_bmp(7, -5, 24, bmp_rows(img.reshape(5, -1), 8)))


def test_bit_field_masks_of_other_forms_are_refused():
    rows = bmp_rows(np.zeros((2, 6), np.uint8), 8)
    _refused_as_cv2(write_bmp(3, 2, 16, rows, 3, masks=(0xF00, 0xF0, 0xF)),
                    "not 5-5-5 or 5-6-5")
    # a v4 header's own masks are not where OpenCV reads them
    body = write_bmp(3, 2, 16, rows, 3, header=108)
    _refused_as_cv2(body, "masks")


# RLE: (name, width, height, bpp, ops) with each escape and its edge
RLE_CASES = [
    ("runs-eol-absolute-eob", 5, 4, 8,
     [3, 1, 2, 2, 0, 0, 5, 3, 0, 0, 0, 3, 4, 5, 6, 0, 2, 7, 0, 0, 0, 1]),
    ("eol-at-a-row-start-skips-it", 5, 4, 8, [0, 0, 5, 3, 0, 0, 0, 1]),
    ("runs-that-end-rows", 5, 4, 8, [5, 3, 5, 4, 0, 1]),
    ("absolute-to-the-row-end-then-eol", 5, 4, 8,
     [0, 5, 1, 2, 3, 4, 5, 0, 0, 0, 2, 2, 0, 1]),
    ("early-eob", 5, 4, 8, [3, 1, 0, 1]),
    ("delta-across-rows", 5, 4, 8, [3, 1, 0, 2, 9, 1, 1, 2, 0, 1]),
    ("delta-down", 5, 3, 8, [3, 1, 0, 2, 1, 1, 1, 2, 0, 1]),
    ("delta-two-rows", 5, 3, 8, [3, 1, 0, 2, 0, 2, 1, 2, 0, 1]),
    ("rle4-eob-on-the-last-row", 5, 2, 4,
     [3, 0x12, 0, 0, 2, 0x34, 0, 1]),
    ("rle4-eob-moves-one-row", 5, 3, 4,
     [3, 0x12, 0, 1, 2, 0x34, 0, 0, 0, 0, 0, 0]),
    ("rle4-absolute", 5, 2, 4,
     [0, 5, 0x12, 0x34, 0x50, 0, 0, 0, 2, 0x34, 0, 1]),
    ("rle4-delta-goes-across-only", 5, 3, 4,
     [3, 0x12, 0, 2, 0, 5, 2, 0x34, 0, 0, 0, 0, 0, 0]),
    ("rle4-delta-wraps", 5, 3, 4,
     [3, 0x12, 0, 2, 9, 0, 2, 0x34, 0, 0, 0, 0]),
    ("rle4-eol-at-a-row-start", 5, 2, 4, [0, 0, 2, 0x34, 0, 1]),
]
RLE_REFUSED = [
    ("run-past-its-row", 5, 4, 8, [6, 1, 0, 1], "passes the end of its row"),
    ("absolute-past-its-row", 5, 4, 8, [0, 6, 1, 2, 3, 4, 5, 6, 0, 1],
     "passes the end of its row"),
    ("truncated", 5, 4, 8, [3, 1], "truncated BMP RLE data"),
    ("rle4-eob-on-the-first-row", 5, 2, 4, [3, 0x12, 0, 1],
     "truncated BMP RLE data"),
]


def _rle_body(w, h, bpp, ops):
    pal = np.random.default_rng(bpp).integers(0, 256, (1 << bpp, 3))
    return write_bmp(w, h, bpp, bytes(ops), 1 if bpp == 8 else 2, rgbq(pal))


@pytest.mark.parametrize("name,w,h,bpp,ops", RLE_CASES,
                         ids=[c[0] for c in RLE_CASES])
def test_rle_equals_cv2(name, w, h, bpp, ops):
    _same(_rle_body(w, h, bpp, ops))


@pytest.mark.parametrize("name,w,h,bpp,ops,what", RLE_REFUSED,
                         ids=[c[0] for c in RLE_REFUSED])
def test_rle_that_opencv_refuses_is_refused(name, w, h, bpp, ops, what):
    _refused_as_cv2(_rle_body(w, h, bpp, ops), what)


def test_truncated_pixel_data_is_refused_before_allocation():
    """A 60-byte body that declares 16384 x 16384 at 24 bpp, and one that
    declares more pixels than OpenCV reads: refused before the image is
    sized, within a few MB of traced memory."""
    huge = write_bmp(16384, 16384, 24, bytes(6))
    over = write_bmp(1 << 16, 1 << 16, 8, bytes(6),
                     palette=rgbq(np.zeros((256, 3))))
    tracemalloc.start()
    try:
        for body, what in ((huge, "truncated BMP pixel data"),
                           (over, "over OpenCV's limits")):
            with pytest.raises(ValueError, match=what):
                imdecode.decode_image_u8(body)
        assert tracemalloc.get_traced_memory()[1] < 4 << 20
    finally:
        tracemalloc.stop()
    assert _cv2_rgb(huge) is None


def test_expected_size_refuses_another_header_before_reading_pixels():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".bmp", img)
    body = buf.tobytes()
    with pytest.raises(ValueError, match="expected 24x16 LR input, got a "
                                         "16x24 BMP"):
        imdecode.decode_image_u8(body, expected_hw=(24, 16))
    np.testing.assert_array_equal(
        imdecode.decode_image_u8(body, expected_hw=(16, 24)), img[..., ::-1])
