"""The port's JPEG decoder (``tpusr_torch/pipeline/jpeg.py``) against
``cv2.imdecode(IMREAD_COLOR)``, which the JAX package decodes with (the
progressive, RGB, CMYK and other-sampling cases are in
``test_torch_jpeg_formats.py``).

Tolerance: none. Every baseline case decodes to cv2's bytes exactly
(swapped to RGB): qualities 50-100, 4:4:4, 4:2:2, 4:2:0 and 4:4:0, odd
sizes, gray, restart intervals, optimised Huffman tables, PIL's encoder and
every EXIF orientation, and what the baseline decoder refused (progressive,
SOF1, 4:1:1, RGB, CMYK). What the decoder refuses raises naming it, and a
crafted header is refused before memory is sized from it.
"""

import hashlib
import io
import json
import os
import struct
import tracemalloc

import cv2
import numpy as np
import pytest
from PIL import Image

from tpusr_torch.pipeline import imdecode, jpeg, png

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _scene(seed, h, w, channels=3):
    """A smooth random field plus noise: what a camera frame compresses
    like (flat areas and edges both)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(h // 4 + 2, w // 4 + 2, channels)).cumsum(0).cumsum(1)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    x = (x - x.min()) / (np.ptp(x) + 1e-9) * 255 + rng.normal(scale=10,
                                                              size=x.shape)
    return np.clip(x, 0, 255).astype(np.uint8).reshape(h, w, channels)


def _encode(bgr, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", bgr, list(params))
    assert ok
    return buf.tobytes()


def _cv2_rgb(body: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return bgr[..., ::-1]


def _same_as_cv2(body: bytes):
    got = jpeg.decode_jpeg_u8(body)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_rgb(body))


@pytest.mark.parametrize("quality", [50, 75, 90, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_equal_to_cv2_at_every_quality_and_sampling(quality, sampling):
    for k, (h, w) in enumerate([(48, 64), (37, 45), (17, 9)]):
        img = _scene(100 * quality + k, h, w)
        _same_as_cv2(_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             SAMPLING[sampling]))


@pytest.mark.parametrize("hw", [(1, 1), (2, 5), (3, 17), (16, 16), (33, 8)])
def test_equal_to_cv2_at_tiny_and_edge_sizes(hw):
    """Chroma one or two samples wide (libjpeg's box upsampling), a single
    MCU, partial MCUs on both edges."""
    img = _scene(sum(hw), max(hw[0], 4), max(hw[1], 4))[:hw[0], :hw[1]]
    for sampling in ("420", "422", "444"):
        _same_as_cv2(_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             SAMPLING[sampling]))


@pytest.mark.parametrize("quality", [50, 85, 100])
def test_equal_to_cv2_on_gray(quality):
    _same_as_cv2(_encode(_scene(quality, 41, 30, 1)[..., 0],
                         cv2.IMWRITE_JPEG_QUALITY, quality))


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_equal_to_cv2_with_restart_intervals(interval):
    img = _scene(interval, 64, 72)
    for sampling in ("420", "444"):
        _same_as_cv2(_encode(img, cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             SAMPLING[sampling]))
    _same_as_cv2(_encode(img[..., 0], cv2.IMWRITE_JPEG_RST_INTERVAL, interval))


def test_equal_to_cv2_with_optimised_huffman_tables():
    img = _scene(5, 40, 56)
    _same_as_cv2(_encode(img, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                         cv2.IMWRITE_JPEG_QUALITY, 80))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_equal_to_cv2_on_pil_written_jpegs(subsampling):
    """Another encoder's tables, and its JFIF header."""
    img = _scene(subsampling, 45, 38)
    for quality in (30, 95):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=subsampling)
        _same_as_cv2(buf.getvalue())


def _exif(orientation: int, order: str) -> bytes:
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 2)
            + struct.pack(e + "HHI", 0x010F, 2, 4) + b"cam\x00"
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("order", ["II", "MM"])
def test_exif_orientation_applied_as_cv2_applies_it(orientation, order):
    body = _encode(_scene(orientation, 24, 40), cv2.IMWRITE_JPEG_QUALITY, 90)
    body = body[:2] + _exif(orientation, order) + body[2:]
    got = jpeg.decode_jpeg_u8(body)
    assert got.shape[:2] == ((40, 24) if orientation >= 5 else (24, 40))
    np.testing.assert_array_equal(got, _cv2_rgb(body))


def test_committed_fixtures_decode_to_their_cv2_pngs():
    """The fixtures the card's smoke run checks the decoder on (that
    machine has no OpenCV): each JPEG's committed cv2 decode is what cv2
    gives now, and what the port gives."""
    names = sorted(f[:-4] for f in os.listdir(DATA) if f.endswith(".jpg"))
    with open(os.path.join(DATA, "decoded.json")) as f:
        decoded = json.load(f)
    assert len(names) == 10 and sorted(decoded) == names
    for name in names:
        with open(os.path.join(DATA, f"{name}.jpg"), "rb") as f:
            body = f.read()
        got = imdecode.decode_image_u8(body)
        np.testing.assert_array_equal(got, _cv2_rgb(body))
        assert list(got.shape) == decoded[name]["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == decoded[name]["sha256"]
        if os.path.exists(os.path.join(DATA, f"{name}.png")):
            with open(os.path.join(DATA, f"{name}.png"), "rb") as f:
                np.testing.assert_array_equal(png.decode_png_u8(f.read()), got)


def _patched_sof(body: bytes, marker: int | None = None,
                 precision: int | None = None) -> bytes:
    i = body.index(b"\xff\xc0")
    b = bytearray(body)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


def _segment(marker: int, data: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(data) + 2) + data


def _without_jfif(body: bytes) -> bytes:
    assert body[2:4] == b"\xff\xe0"
    (length,) = struct.unpack(">H", body[4:6])
    return body[:2] + body[4 + length:]


def _as_rgb(body: bytes, how: str) -> bytes:
    """A YCbCr JPEG relabelled as libjpeg reads RGB: no JFIF marker, and an
    Adobe marker with transform 0 or the component ids R, G, B."""
    body = _without_jfif(body)
    if how == "adobe":
        adobe = b"Adobe" + b"\x00\x64" + b"\x00\x00" * 2 + b"\x00"
        return body[:2] + _segment(0xEE, adobe) + body[2:]
    b = bytearray(body)
    sof, sos = body.index(b"\xff\xc0"), body.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        b[sof + 10 + 3 * k] = cid
        b[sos + 5 + 2 * k] = cid
    return bytes(b)


def _second_scan(body: bytes) -> bytes:
    """The scan (SOS and its data) sent twice."""
    sos, eoi = body.index(b"\xff\xda"), body.rindex(b"\xff\xd9")
    return body[:eoi] + body[sos:eoi] + body[eoi:]


def _unrefined(body: bytes) -> bytes:
    """A progressive file cut after its first scan, EOI appended."""
    sos = body.index(b"\xff\xda")
    nxt = sos + 2
    while not (body[nxt] == 0xFF and body[nxt + 1] not in (0, *range(0xD0, 0xD8))):
        nxt += 1
    return body[:nxt] + b"\xff\xd9"


def test_what_the_decoder_refuses_raises_naming_it():
    img = _scene(9, 24, 24)
    base = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    cases = [
        (_patched_sof(base, marker=0xC9), "arithmetic-coded JPEG"),
        (_patched_sof(base, marker=0xC3), "lossless JPEG"),
        (_patched_sof(base, precision=12), "12-bit JPEG"),
        (_second_scan(_encode(img[..., 0])), "coded in two scans"),
        (base[:len(base) // 2], "truncated"),
        (_unrefined(_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
         "unrefined progressive JPEG"),
    ]
    for body, what in cases:
        with pytest.raises(ValueError, match=what):
            imdecode.decode_image_u8(body)


def _formerly_refused(case: str) -> bytes:
    img = _scene(9, 24, 24)
    base = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    if case == "progressive":
        return _encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    if case == "sof1":
        return _patched_sof(base, marker=0xC1)
    if case == "411":
        return _encode(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    if case.startswith("rgb-"):
        return _as_rgb(base, case[4:])
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("case", ["progressive", "sof1", "411", "rgb-adobe",
                                  "rgb-ids", "cmyk"])
def test_formerly_refused_jpegs_decode_equal_to_cv2(case):
    """What the baseline decoder refused (progressive, SOF1, 4:1:1, RGB by
    Adobe transform or by component ids, CMYK) decodes as cv2 decodes it."""
    _same_as_cv2(_formerly_refused(case))


def test_cv2_reads_the_refused_rgb_jpegs_as_rgb():
    """The relabelled files above are what libjpeg takes for RGB: cv2 gives
    the stored planes unconverted, not their YCbCr conversion, and so does
    the decoder."""
    img = _scene(9, 24, 24)
    base = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    for how in ("adobe", "ids"):
        body = _as_rgb(base, how)
        assert not np.array_equal(_cv2_rgb(body), _cv2_rgb(base))
        _same_as_cv2(body)
        frame, _ = jpeg.parse_jpeg(body)
        assert frame.colorspace == "rgb"


def _resized_sof(body: bytes, h: int, w: int) -> bytes:
    i = body.index(b"\xff\xc0")
    return body[:i + 5] + struct.pack(">HH", h, w) + body[i + 9:]


def _peak_bytes(fn):
    """fn()'s peak of traced Python and numpy memory."""
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


@pytest.mark.parametrize("h,w,channels,what", [
    (65535, 65535, 1, r"over 2\^30 pixels"),
    (32768, 32768, 1, "truncated JPEG scan"),
    (16384, 16384, 3, "truncated JPEG scan")])
def test_a_crafted_frame_header_is_refused_in_bounded_memory(h, w, channels,
                                                            what):
    """A body of a few hundred bytes that declares a huge frame is refused
    before coefficients, offsets or bit windows are sized from it."""
    img = _scene(h % 97, 16, 16, channels)
    body = _resized_sof(_encode(img[..., 0] if channels == 1 else img,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444), h, w)
    assert len(body) < 1000

    def decode():
        with pytest.raises(ValueError, match=what):
            imdecode.decode_image_u8(body)
    assert _peak_bytes(decode) < 16 << 20


def test_expected_size_refuses_another_frame_before_decoding(monkeypatch):
    body = _encode(_scene(1, 24, 40), cv2.IMWRITE_JPEG_QUALITY, 90)
    built = []
    monkeypatch.setattr(jpeg, "_bit_windows",
                        lambda *a: built.append(1) or (_ for _ in ()).throw(
                            AssertionError("a scan was decoded")))
    for bad in (body, _resized_sof(body, 8192, 8192)):
        with pytest.raises(ValueError, match="expected 128x128 LR input"):
            imdecode.decode_image_u8(bad, expected_hw=(128, 128))
    img = _scene(2, 16, 16)
    with pytest.raises(ValueError, match="expected 128x128 LR input"):
        imdecode.decode_image_u8(png.encode_png_u8(img), expected_hw=(128, 128))
    assert not built
    monkeypatch.undo()
    # the transposed frame passes: an EXIF tag may turn it to the size
    turned = body[:2] + _exif(6, "II") + body[2:]
    got = imdecode.decode_image_u8(turned, expected_hw=(40, 24))
    np.testing.assert_array_equal(got, _cv2_rgb(turned))
    np.testing.assert_array_equal(
        imdecode.decode_image_u8(png.encode_png_u8(img), expected_hw=(16, 16)),
        img)


def test_huffman_tables_are_built_only_for_a_scan(monkeypatch):
    """Hundreds of distinct DHT tables in one body cost their parse only:
    the lookup lists are built for the tables a scan uses."""
    body = _encode(_scene(4, 16, 24), cv2.IMWRITE_JPEG_QUALITY, 80)
    counts = bytes([0, 2] + [0] * 14)
    tables = b"".join(_segment(0xC4, bytes([0x11]) + counts + bytes([a, b]))
                      for a in range(20) for b in range(20))
    crafted = body[:2] + tables + body[2:]
    n_built = []

    class Counted(jpeg._Huffman):
        def __init__(self, *a):
            n_built.append(1)
            super().__init__(*a)
    monkeypatch.setattr(jpeg, "_Huffman", Counted)
    jpeg._huffman.cache_clear()
    np.testing.assert_array_equal(jpeg.decode_jpeg_u8(crafted),
                                  _cv2_rgb(crafted))
    assert len(n_built) == 4        # two DC and two AC tables, once each
    jpeg._huffman.cache_clear()
    bad = body[:2] + _segment(0xC4, bytes([0x14]) + counts + b"\0\1") + body[2:]
    with pytest.raises(ValueError, match="Huffman table segment"):
        jpeg.decode_jpeg_u8(bad)


def test_bytes_past_the_scans_blocks_are_not_windowed():
    """A megabyte of junk between the last block and EOI: cv2 skips it (a
    warning), and so does the decoder, without windowing it."""
    body = _encode(_scene(6, 16, 16), cv2.IMWRITE_JPEG_QUALITY, 90)
    eoi = body.rindex(b"\xff\xd9")
    junk = np.random.default_rng(6).integers(0, 255, 1 << 20,
                                             dtype=np.uint8).tobytes()
    padded = body[:eoi] + junk + body[eoi:]
    want = _cv2_rgb(padded)
    np.testing.assert_array_equal(want, _cv2_rgb(body))
    got = []
    assert _peak_bytes(lambda: got.append(jpeg.decode_jpeg_u8(padded))) \
        < 16 << 20
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("fmt,ext", [("GIF", ".gif"), ("BMP", ".bmp"),
                                     ("TIFF", ".tiff"), ("WebP", ".webp")])
def test_other_formats_raise_naming_the_format(fmt, ext):
    """GIF, BMP, TIFF and WebP, which raised before the port read them,
    decode equal to cv2; a format the port does not read (JPEG 2000)
    raises naming it."""
    img = _scene(3, 16, 16)
    if fmt == "GIF":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "GIF")
        body = buf.getvalue()
    else:
        ok, b = cv2.imencode(ext, img)
        assert ok
        body = b.tobytes()
    assert imdecode.image_format(body) == fmt
    np.testing.assert_array_equal(imdecode.decode_image_u8(body),
                                  _cv2_rgb(body))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000")
    with pytest.raises(ValueError, match="a JPEG 2000 image"):
        imdecode.decode_image_u8(buf.getvalue())
    assert imdecode.decode_image(png.encode_png_u8(img)).dtype == np.float32
