"""The port's JPEG decoder (``tpusr_torch/pipeline/jpeg.py``) on what
libjpeg-turbo decodes beyond baseline YCbCr at 4:4:4/4:2:2/4:4:0/4:2:0:
progressive JPEG (cv2's and Pillow's scan scripts, and edited ones), SOF1,
RGB, CMYK and YCCK, and every integral sampling ratio. Held against
``cv2.imdecode(IMREAD_COLOR)`` swapped to RGB, with no tolerance. A
progressive file whose scans leave a bit unrefined is refused by name (cv2
smooths such blocks), as are crafted SOF2 headers, in bounded memory.
"""

import io
import struct
import tracemalloc

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_jpeg import SAMPLING, _exif, _scene
from torch_image_writers import jpeg_segments, random_components, write_jpeg
from tpusr_torch.pipeline import imdecode, jpeg

SAMPLING_ALL = dict(SAMPLING, **{"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411})


def _encode(bgr, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", bgr, list(params))
    assert ok
    return buf.tobytes()


def _cv2_rgb(body: bytes):
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def _same(body: bytes):
    want = _cv2_rgb(body)
    assert want is not None
    got = jpeg.decode_jpeg_u8(body)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _progressive(img, quality=90, sampling="420", *params):
    return _encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                   cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING_ALL[sampling],
                   *params)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING_ALL))
def test_progressive_equals_cv2_at_every_quality_and_sampling(quality,
                                                              sampling):
    """cv2's scan script (DC first at Al 1, AC bands with successive
    approximation, their refinements, the DC refinement), odd sizes and
    chroma one or two samples wide; the full decode is also the baseline
    file's."""
    for k, (h, w) in enumerate([(37, 45), (17, 9), (1, 1), (3, 17)]):
        img = _scene(quality + 7 * k, max(h, 4), max(w, 4))[:h, :w]
        body = _progressive(img, quality, sampling)
        _same(body)
        if k == 0:
            base = _encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           SAMPLING_ALL[sampling])
            np.testing.assert_array_equal(jpeg.decode_jpeg_u8(body),
                                          jpeg.decode_jpeg_u8(base))


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_progressive_with_restart_intervals_equals_cv2(interval):
    img = _scene(interval, 40, 56)
    _same(_progressive(img, 85, "420", cv2.IMWRITE_JPEG_RST_INTERVAL, interval))
    _same(_encode(img[..., 0], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, interval))


def test_progressive_gray_and_optimised_tables_equal_cv2():
    img = _scene(5, 41, 30)
    _same(_encode(img[..., 0], cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    _same(_progressive(img, 80, "444", cv2.IMWRITE_JPEG_OPTIMIZE, 1))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_progressive_jpegs_equal_cv2(subsampling):
    img = _scene(subsampling, 45, 38)
    for quality in (30, 95):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=subsampling, progressive=True)
        _same(buf.getvalue())


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_progressive_exif_orientation_applied_as_cv2(orientation):
    body = _progressive(_scene(orientation, 24, 40))
    _same(body[:2] + _exif(orientation, "II") + body[2:])


def _scans(body):
    """(the segments before the first scan, [(tables before it, scan)],
    EOI): each scan with the DHT/DQT segments that precede it."""
    segs = jpeg_segments(body)
    first = next(i for i, (m, _) in enumerate(segs) if m == 0xDA)
    head = b"".join(s for _, s in segs[:first])
    k = first
    while segs[k - 1][0] in (0xC4, 0xDB):
        k -= 1
    head = b"".join(s for _, s in segs[:k])
    scans, tables = [], b""
    for m, s in segs[k:-1]:
        if m == 0xDA:
            scans.append((tables, s))
            tables = b""
        else:
            tables += s
    return head, scans, segs[-1][1]


def _scan_params(scan: bytes):
    n = scan[4]
    ids = tuple(scan[5 + 2 * i] for i in range(n))
    ss, se, a = scan[5 + 2 * n: 8 + 2 * n]
    return ids, ss, se, a >> 4


def order_ok(params, order) -> bool:
    """Whether each refinement scan comes after the scans that first code
    its coefficients."""
    seen = set()
    for i in order:
        ids, ss, se, ah = params[i]
        band = {(c, k) for c in ids for k in range(ss, se + 1)}
        if ah and not band <= seen:
            return False
        seen |= band
    return True


def test_edited_scan_scripts_decode_as_cv2():
    """cv2's ten scans reordered where the progression allows (a
    component's AC bands before another's, the DC refinement before the AC
    scans), and the quantisation tables redefined after the first scan:
    each gives cv2's decode of the file as written."""
    img = _scene(11, 40, 48)
    body = _progressive(img, 90, "420")
    head, scans, eoi = _scans(body)
    want = _cv2_rgb(body)
    params = [_scan_params(s) for _, s in scans]
    dc = [i for i, p in enumerate(params) if p[1] == 0]
    ac = [i for i, p in enumerate(params) if p[1] > 0]
    # every DC scan first, then each component's AC scans, the last
    # component first (each component's scans keep their order)
    by_comp = sorted(ac, key=lambda i: (-params[i][0][0], i))
    assert len(dc) == 2 and len(by_comp) == 8 and order_ok(params, dc + by_comp)
    for order in (dc + by_comp, dc[:1] + ac + dc[1:]):
        edited = head + b"".join(t + s for t, s in (scans[i] for i in order)) \
            + eoi
        assert order != list(range(len(scans)))
        np.testing.assert_array_equal(_cv2_rgb(edited), want)
        np.testing.assert_array_equal(jpeg.decode_jpeg_u8(edited), want)
    # a DQT after the first scan redefines tables 0 and 1: every component
    # latched its table at that scan (libjpeg's latch_quant_tables)
    dqt = b"".join(bytes([0xFF, 0xDB, 0, 67, t]) + bytes([1] * 64)
                   for t in (0, 1))
    later = head + scans[0][0] + scans[0][1] + dqt + b"".join(
        t + s for t, s in scans[1:]) + eoi
    np.testing.assert_array_equal(_cv2_rgb(later), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg_u8(later), want)


@pytest.mark.parametrize("keep", [2, 4, 6, 9])
def test_unrefined_progressive_jpeg_is_refused_by_name(keep):
    """Cut after ``keep`` of cv2's ten scans, with its EOI: cv2 decodes it
    with libjpeg's block smoothing; the decoder refuses it, naming what it
    is. Truncated within the next scan, with no EOI, both refuse it."""
    body = _progressive(_scene(keep, 40, 48))
    head, scans, eoi = _scans(body)
    cut = head + b"".join(t + s for t, s in scans[:keep])
    assert _cv2_rgb(cut + eoi) is not None
    truncated = cut + scans[keep][0] + scans[keep][1][:40]
    assert _cv2_rgb(truncated) is None
    for short in (cut + eoi, truncated):
        with pytest.raises(ValueError, match="unrefined progressive JPEG"):
            imdecode.decode_image_u8(short)


@pytest.mark.parametrize("factors", [
    ((4, 1), (1, 1), (1, 1)), ((4, 2), (1, 1), (1, 1)),
    ((3, 1), (1, 1), (1, 1)), ((1, 3), (1, 1), (1, 1)),
    ((3, 2), (1, 1), (1, 1)), ((2, 2), (2, 1), (1, 2)),
    ((4, 1), (2, 1), (1, 1)), ((2, 1), (1, 1), (2, 1))],
    ids=lambda f: "-".join(f"h{h}v{v}" for h, v in f))
def test_every_integral_sampling_ratio_equals_cv2(factors):
    """Box replication (``int_upsample``) where the ratio is not 1 or 2,
    the fancy paths where it is, restarts and SOF1 on the same data."""
    rng = np.random.default_rng(len(factors) + sum(h * v for h, v in factors))
    for w, h in ((37, 29), (5, 3), (64, 48)):
        comps = random_components(rng, w, h, factors)
        _same(write_jpeg(comps, w, h))
        _same(write_jpeg(comps, w, h, restart=2, sof=0xC1))


def test_a_fractional_ratio_and_an_oversized_mcu_are_refused():
    rng = np.random.default_rng(1)
    for factors, what in ((((3, 1), (2, 1), (1, 1)), "fractional ratio"),
                          (((4, 4), (2, 2), (1, 1)), "more than 10 blocks")):
        body = write_jpeg(random_components(rng, 37, 29, factors), 37, 29)
        assert _cv2_rgb(body) is None
        with pytest.raises(ValueError, match=what):
            jpeg.decode_jpeg_u8(body)


@pytest.mark.parametrize("space", ["rgb-adobe", "rgb-ids", "cmyk", "ycck",
                                   "cmyk-no-adobe", "ycc-adobe-1"])
def test_colour_spaces_equal_cv2(space):
    """What libjpeg's ``default_decompress_parms`` takes each frame for:
    RGB (Adobe transform 0, or components R, G, B without JFIF), CMYK
    (transform 0 or no Adobe marker) and YCCK (transform 2) through
    OpenCV's CMYK->BGR step, YCbCr (transform 1)."""
    rng = np.random.default_rng(len(space))
    n = 4 if space.startswith(("cmyk", "ycck")) else 3
    for factors in (((1, 1),) * n, ((2, 2),) + ((1, 1),) * (n - 1)):
        comps = random_components(rng, 29, 19, factors)
        if space == "rgb-ids":
            comps = [(ord(c), *rest) for c, (_, *rest) in zip("RGB", comps)]
        adobe = {"rgb-adobe": 0, "cmyk": 0, "ycck": 2,
                 "ycc-adobe-1": 1}.get(space)
        _same(write_jpeg(comps, 29, 19, adobe=adobe, jfif=False))


@pytest.mark.parametrize("progressive", [False, True])
def test_pil_cmyk_jpegs_equal_cv2(progressive):
    for k, quality in enumerate((30, 75, 95)):
        img = _scene(k, 23, 31)
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=quality,
                                                  progressive=progressive)
        _same(buf.getvalue())


def _resized_sof2(body: bytes, h: int, w: int) -> bytes:
    i = body.index(b"\xff\xc2")
    return body[:i + 5] + struct.pack(">HH", h, w) + body[i + 9:]


@pytest.mark.parametrize("h,w,channels,what", [
    (65535, 65535, 3, r"over 2\^30 pixels"),
    (32768, 32768, 1, "truncated JPEG scan"),
    (16384, 16384, 3, "truncated JPEG scan")])
def test_a_crafted_sof2_header_is_refused_in_bounded_memory(h, w, channels,
                                                           what):
    """A progressive body of a few hundred bytes that declares a huge
    frame: its first (DC) scan carries less than a bit a block, so it is
    refused before any coefficient list is sized."""
    img = _scene(h % 97, 16, 16, channels)
    body = _resized_sof2(_encode(img[..., 0] if channels == 1 else img,
                                 cv2.IMWRITE_JPEG_PROGRESSIVE, 1), h, w)
    assert len(body) < 2000
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=what):
            imdecode.decode_image_u8(body)
        assert tracemalloc.get_traced_memory()[1] < 16 << 20
    finally:
        tracemalloc.stop()


def test_an_ac_scan_before_its_dc_scan_is_refused():
    body = _progressive(_scene(3, 24, 24))
    head, scans, eoi = _scans(body)
    dc = [i for i, (_, s) in enumerate(scans) if _scan_params(s)[1] == 0]
    rest = [i for i in range(len(scans)) if i not in dc]
    edited = head + b"".join(scans[i][0] + scans[i][1]
                             for i in rest[:1] + dc + rest[1:]) + eoi
    with pytest.raises(ValueError, match="AC scan before its DC scan"):
        jpeg.decode_jpeg_u8(edited)


def test_expected_size_refuses_a_progressive_frame_before_its_scans(
        monkeypatch):
    body = _progressive(_scene(4, 24, 40))
    monkeypatch.setattr(jpeg, "_bit_windows", lambda *a: (_ for _ in ()).throw(
        AssertionError("a scan was decoded")))
    with pytest.raises(ValueError, match="expected 128x128 LR input"):
        imdecode.decode_image_u8(body, expected_hw=(128, 128))
