"""The port's TIFF decoder (``tpusr_torch/pipeline/tiff.py``) against
``cv2.imdecode(IMREAD_COLOR)`` swapped to RGB, with no tolerance: OpenCV
reads every TIFF at 8 bits through libtiff's RGBA interface, whose
conversions the decoder follows (16-bit RGB rounded, 16-bit gray as its
high byte, unassociated alpha premultiplied, gray in planar files taken as
RGB, the drifting rows of clipped gray tiles). Files from Pillow (libtiff)
and hand-built ones (``tests/torch_image_writers.py``): strips and tiles,
chunky and planar, none/LZW/Deflate/PackBits, predictor 2 at 8 and 16
bits, both byte orders, BigTIFF, MinIsWhite/MinIsBlack/RGB/palette at 1, 4,
8 and 16 bits, every orientation. What is left out is refused by name; a
crafted header and a decompression bomb are refused in bounded memory.
"""

import io
import tracemalloc
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_image_writers import write_tiff
from tpusr_torch.pipeline import imdecode, tiff

LAYOUTS = {"strip": {}, "strips5": {"rows_per_strip": 5},
           "tile16": {"tile": (16, 16)}, "tile32": {"tile": (32, 32)},
           "planar": {"planar": 2, "rows_per_strip": 4},
           "planar-tile": {"planar": 2, "tile": (16, 16)}}
# (name, photometric, samples, ExtraSamples)
KINDS = [("white", 0, 1, None), ("black", 1, 1, None),
         ("gray-alpha", 1, 2, [2]), ("rgb", 2, 3, None),
         ("rgba-unspecified", 2, 4, [0]), ("rgba-assoc", 2, 4, [1]),
         ("rgba-unassoc", 2, 4, [2])]


def _cv2_rgb(body: bytes):
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _same(body: bytes):
    want = _cv2_rgb(body)
    got = tiff.decode_tiff_u8(body)
    assert want is not None
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _samples(rng, kind, dtype):
    _, _, spp, _ = kind
    hi = 65536 if dtype == np.uint16 else 256
    x = rng.integers(0, hi, (13, 11, spp)).astype(dtype)
    x[:6] = (np.arange(11)[None, :, None] * (hi // 16)).astype(dtype)
    return x


@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["8", "16"])
def test_every_layout_compression_and_kind_equals_cv2(dtype, kind,
                                                      compression):
    """Each layout in both byte orders, with and without predictor 2 (run
    by libtiff for LZW and Deflate only, ignored for the others); BigTIFF
    once. Uncompressed tiles whose size is no multiple of 1024 bytes are
    refused as libtiff refuses them."""
    rng = np.random.default_rng(compression + kind[2] + dtype().itemsize)
    x = _samples(rng, kind, dtype)
    for name, layout in LAYOUTS.items():
        for predictor in (1, 2):
            for order in ("<", ">"):
                body = write_tiff(x, photometric=kind[1], extra=kind[3],
                                  compression=compression, predictor=predictor,
                                  order=order, **layout)
                tile = layout.get("tile")
                spp = 1 if layout.get("planar") == 2 else kind[2]
                if compression == 1 and tile and \
                        (tile[0] * tile[1] * spp * dtype().itemsize) % 1024:
                    assert _cv2_rgb(body) is None
                    with pytest.raises(ValueError, match="multiple of 1024"):
                        tiff.decode_tiff_u8(body)
                    continue
                _same(body)
    _same(write_tiff(x, photometric=kind[1], extra=kind[3], big=True,
                     compression=compression, rows_per_strip=4))


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_palette_tiffs_equal_cv2(bits):
    """A 16-bit colour map as its high bytes; one whose entries are all
    under 256 taken as 8-bit, as libtiff's ``checkcmap`` takes it."""
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, (13, 11)).astype(np.uint8)
    for cmap in (rng.integers(0, 65536, (1 << bits, 3)),
                 rng.integers(0, 256, (1 << bits, 3))):
        for compression in (1, 5, 8, 32773):
            _same(write_tiff(idx, photometric=3, colormap=cmap, bits=bits,
                             compression=compression, rows_per_strip=5))


@pytest.mark.parametrize("photometric", [0, 1])
def test_bilevel_tiffs_equal_cv2(photometric):
    rng = np.random.default_rng(photometric)
    b = rng.integers(0, 2, (13, 11)).astype(np.uint8)
    for compression in (1, 5, 8, 32773):
        _same(write_tiff(b, photometric=photometric, bits=1,
                         compression=compression, rows_per_strip=4))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_applied_as_cv2_applies_it(orientation):
    rng = np.random.default_rng(orientation)
    img = rng.integers(0, 256, (4, 7, 3)).astype(np.uint8)
    for rps in (None, 3):
        body = write_tiff(img, orientation=orientation, rows_per_strip=rps)
        got = tiff.decode_tiff_u8(body)
        assert got.shape[:2] == ((7, 4) if orientation >= 5 else (4, 7))
        _same(body)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "I;16", "LA"])
@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_adobe_deflate",
                                         "packbits", "tiff_deflate"])
def test_pil_written_tiffs_equal_cv2(mode, compression):
    rng = np.random.default_rng(len(mode))
    img = rng.integers(0, 256, (40, 33, 3)).astype(np.uint8)
    if mode == "I;16":
        im = Image.fromarray(img[..., 0].astype(np.uint16) * 257)
    else:
        im = Image.fromarray(img).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=compression)
    _same(buf.getvalue())


def test_signed_samples_read_as_unsigned_as_cv2_reads_them():
    g = np.random.default_rng(9).integers(0, 256, (13, 11)).astype(np.uint8)
    _same(write_tiff(g, photometric=1, sample_format=2))


def test_a_multi_page_tiff_gives_its_first_page():
    rng = np.random.default_rng(10)
    pages = [Image.fromarray(rng.integers(0, 256, (9, 7, 3)).astype(np.uint8))
             for _ in range(3)]
    buf = io.BytesIO()
    pages[0].save(buf, "TIFF", save_all=True, append_images=pages[1:],
                  compression="tiff_lzw")
    _same(buf.getvalue())
    np.testing.assert_array_equal(tiff.decode_tiff_u8(buf.getvalue()),
                                  np.asarray(pages[0]))


def test_what_the_decoder_leaves_out_is_refused_by_name():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    cases = []
    for mode, comp, what in (("RGB", "jpeg", "JPEG-compressed TIFF"),
                             ("1", "group4", "CCITT Group 4-compressed"),
                             ("1", "group3", "CCITT Group 3-compressed"),
                             ("CMYK", None, "CMYK"), ("YCbCr", None, "YCbCr"),
                             ("F", None, "floating-point TIFF")):
        im = Image.fromarray(img).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression=comp)
        cases.append((buf.getvalue(), what))
    cases += [
        (write_tiff(img[..., 0] // 64, photometric=1, bits=2),
         "2-bit TIFF is not supported"),
        (write_tiff(img[..., 0] // 16, photometric=1, bits=4),
         "4-bit TIFF is not supported"),
        (write_tiff(np.dstack([img, img[..., :2]]), extra=[2, 0]),
         "5 samples per pixel"),
        (write_tiff(img, compression=5, predictor=3), "floating-point TIFF"),
        (write_tiff(img, photometric=8), "CIELab TIFF")]
    for body, what in cases:
        with pytest.raises(ValueError, match=what):
            imdecode.decode_image_u8(body)


def _peak(fn):
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_a_crafted_huge_header_is_refused_in_bounded_memory(compression):
    """A body of a few hundred bytes that declares a 16000 x 16000 image:
    its strips could not fill it at the codec's greatest expansion, so it
    is refused before the image is sized."""
    body = write_tiff(np.zeros((2, 2, 3), np.uint8), compression=compression)
    ifd = tiff._IFD(body)
    b = bytearray(body)
    for tag in (256, 257, 278):
        _, _, p = ifd.entries[tag]
        b[p:p + 4] = (16000).to_bytes(4, "little")
    crafted = bytes(b)
    assert len(crafted) < 400

    def decode():
        with pytest.raises(ValueError, match="truncated TIFF"):
            imdecode.decode_image_u8(crafted)
    assert _peak(decode) < 8 << 20


def test_a_decompression_bomb_inflates_only_to_its_declared_size():
    """A 64 x 64 Deflate TIFF whose strip inflates to 64 MB: inflated only
    as far as its 12 KB; the decode equals cv2's, in bounded memory."""
    img = np.random.default_rng(12).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    raw = img.tobytes() + bytes(64 << 20)
    body = write_tiff(img, compression=8)
    ifd = tiff._IFD(body)
    strip = zlib.compress(raw, 9)
    (_, _, p_off), (_, _, p_cnt) = ifd.entries[273], ifd.entries[279]
    b = bytearray(body)
    b[p_off:p_off + 4] = len(body).to_bytes(4, "little")
    b[p_cnt:p_cnt + 4] = len(strip).to_bytes(4, "little")
    bomb = bytes(b) + strip
    got = []
    assert _peak(lambda: got.append(tiff.decode_tiff_u8(bomb))) < 8 << 20
    np.testing.assert_array_equal(got[0], _cv2_rgb(bomb))


def test_expected_size_refuses_before_reading_strips(monkeypatch):
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    body = write_tiff(img, compression=5)
    monkeypatch.setattr(tiff, "_inflate", lambda *a: (_ for _ in ()).throw(
        AssertionError("a strip was read")))
    with pytest.raises(ValueError, match="expected 8x8 LR input, got a "
                                         "16x24 TIFF"):
        imdecode.decode_image_u8(body, expected_hw=(8, 8))
    monkeypatch.undo()
    turned = write_tiff(img, compression=5, orientation=6)
    got = imdecode.decode_image_u8(turned, expected_hw=(24, 16))
    np.testing.assert_array_equal(got, _cv2_rgb(turned))
