"""The port's HTTP serving tier: its PNG codec against OpenCV, every endpoint
and status code of ``make_http_server`` over a started ``PipelineServer``,
and the same requests against the JAX package's server on the same weights.

Tolerances: the codec is exact (decoded bytes equal ``cv2.imdecode``'s, and
OpenCV reads the port's PNGs back exactly); over HTTP against JAX, classes
equal, confidences within 1e-5 and the /sr images within one 8-bit level.
"""

import base64
import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_fixtures import (NARROW_WIDTHS, center_classifier_bias,
                                 edsr_tree, vgg16_tree)
from tpusr.pipeline import PipelineServer as JaxPipelineServer
from tpusr.pipeline import make_serving_pipeline as jax_make_pipeline
from tpusr.pipeline.http_serving import make_http_server as jax_make_http
from tpusr_torch.bridge import edsr_from_flax, vgg16_from_flax
from tpusr_torch.models.block1 import extract_patches_reference
from tpusr_torch.pipeline import PipelineServer, make_serving_pipeline
from tpusr_torch.pipeline import png
from tpusr_torch.pipeline.http_serving import make_http_server
from torch_image_writers import (sunras_rows, write_pfm, write_png,
                                 write_sunras, write_tiff)

LR, SCALE, PATCH, STRIDE = 24, 2, 32, 16   # 48x48 SR, 3x3 patch grid


# ------------------------------------------------------------ the codec

def _cv2_rgb(body: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data)))


def _filter_row(line: np.ndarray, prev: np.ndarray, bpp: int, f: int) -> bytes:
    """One scanline under PNG filter ``f`` (the encoder's side)."""
    x = line.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    b = prev.astype(np.int64)
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if f == 0:
        pred = 0
    elif f == 1:
        pred = a
    elif f == 2:
        pred = b
    elif f == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def _raw_png(samples: np.ndarray, depth: int, color: int,
             interlace: int = 0, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG written by hand: (h, w, ch) samples at ``depth`` in colour type
    ``color``, rows filtered by ``filters`` in turn (every filter type), or
    Adam7-interlaced."""
    h, w, ch = samples.shape
    bpp = ch * depth // 8

    def scanlines(img):
        rows = (img.astype(">u2") if depth == 16 else img.astype(np.uint8))
        rows = np.frombuffer(rows.tobytes(), np.uint8).reshape(img.shape[0], -1)
        out, prev = b"", np.zeros(rows.shape[1], np.uint8)
        for r, line in enumerate(rows):
            out += _filter_row(line, prev, bpp, filters[r % len(filters)])
            prev = line
        return out

    if interlace:
        passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
                  (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
        raw = b"".join(scanlines(samples[y0::dy, x0::dx])
                       for y0, x0, dy, dx in passes
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = scanlines(samples)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _samples(rng, shape, depth):
    hi = 256 if depth == 8 else 65536
    s = rng.integers(0, hi, shape)
    s[: shape[0] // 2] = np.linspace(0, hi - 1, shape[1]).astype(np.int64)[
        None, :, None]            # smooth rows, where every filter matters
    return s.astype(np.uint8 if depth == 8 else np.uint16)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_equals_cv2_on_cv2_written_pngs(depth, channels):
    rng = np.random.default_rng(depth + channels)
    img = _samples(rng, (19, 23, channels), depth)
    ok, buf = cv2.imencode(".png", img[..., 0] if channels == 1 else img)
    assert ok
    body = buf.tobytes()
    assert body[24] == depth and body[25] == {1: 0, 3: 2, 4: 6}[channels]
    got = png.decode_png_u8(body)
    assert got.dtype == np.uint8 and got.shape == (19, 23, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(body))
    np.testing.assert_array_equal(png.decode_png(body),
                                  _cv2_rgb(body).astype(np.float32) / 255.0)


@pytest.mark.parametrize("mode,color", [("LA", 4), ("P", 3)])
def test_decode_equals_cv2_on_gray_alpha_and_palette_pngs(mode, color):
    # OpenCV writes neither colour type; PIL does
    rng = np.random.default_rng(color)
    rgb = rng.integers(0, 256, (21, 17, 3)).astype(np.uint8)
    im = (Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=77)
          if mode == "P" else Image.fromarray(rgb[..., :2], "LA"))
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    body = buf.getvalue()
    assert body[25] == color
    np.testing.assert_array_equal(png.decode_png_u8(body), _cv2_rgb(body))


@pytest.mark.parametrize("depth,color,channels", [
    (8, 0, 1), (16, 0, 1), (8, 2, 3), (16, 2, 3), (8, 4, 2), (16, 4, 2),
    (8, 6, 4), (16, 6, 4)])
def test_decode_equals_cv2_under_every_row_filter(depth, color, channels):
    rng = np.random.default_rng(depth * 10 + color)
    body = _raw_png(_samples(rng, (15, 11, channels), depth), depth, color)
    np.testing.assert_array_equal(png.decode_png_u8(body), _cv2_rgb(body))


def test_cv2_reads_the_encoded_png_back_exactly():
    rng = np.random.default_rng(3)
    rgb01 = rng.random((33, 47, 3), dtype=np.float32)
    rgb01[0, :3] = (-0.2, 1.3, 0.5 / 255)       # clipped and rounded ends
    body = png.encode_png(rgb01)
    want = np.clip(rgb01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_cv2_rgb(body), want)
    np.testing.assert_array_equal(png.decode_png_u8(body), want)
    # the JAX server's encoder rounds the same way
    from tpusr.pipeline.http_serving import _encode_png as jax_encode
    np.testing.assert_array_equal(_cv2_rgb(jax_encode(rgb01)), want)


def test_jpeg_and_interlaced_png_are_refused_by_name():
    """The PNG decoder refuses a JPEG by name; an Adam7 PNG, refused before
    the port read interlaced files, decodes equal to cv2 under every row
    filter."""
    img = np.random.default_rng(4).integers(0, 256, (16, 16, 3), np.uint8)
    ok, jpg = cv2.imencode(".jpg", img)
    assert ok
    with pytest.raises(ValueError, match="JPEG"):
        png.decode_png(jpg.tobytes())
    interlaced = _raw_png(img, 8, 2, interlace=1)
    np.testing.assert_array_equal(_cv2_rgb(interlaced), img)  # a valid PNG
    np.testing.assert_array_equal(png.decode_png_u8(interlaced), img)
    with pytest.raises(ValueError, match="not a decodable image"):
        png.decode_png(b"not an image")
    bad_crc = bytearray(png.encode_png(img / 255.0))
    bad_crc[40] ^= 0xFF
    with pytest.raises(ValueError):
        png.decode_png(bytes(bad_crc))


# ------------------------------------------------------------ the server

def _request(url, body=None, method=None):
    """(status, content type, body) of one request."""
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


class _Served:
    """``make_http_server`` over a started server, run on a thread."""

    def __init__(self, make, server, **kw):
        self.server = server.start()
        self.httpd = make(server, (LR, LR), port=0, **kw)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.stop()


def _port_pipeline(sv, cv):
    return make_serving_pipeline(
        edsr_from_flax(sv, SCALE, device="cpu"), vgg16_from_flax(cv, device="cpu"),
        (LR, LR), SCALE, patch=PATCH, stride=STRIDE, sr_mode="f32",
        clf_mode="per_patch_f32", device="cpu")


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(11)
    _, sv = edsr_tree(rng, SCALE, num_res_blocks=1, num_filters=8)
    cv = vgg16_tree(rng, dense_units=256)   # JAX's factory builds Dense 256
    lr = rng.random((6, LR, LR, 3), dtype=np.float32)
    # centre the classifier's bias on these requests, so both classes vote
    pipe = _port_pipeline(sv, cv)
    with torch.inference_mode():
        sr = pipe.sr_apply(torch.as_tensor(lr))
        probs = pipe.clf_apply(extract_patches_reference(sr, PATCH, STRIDE))
    return sv, center_classifier_bias(cv, probs.reshape(len(lr), -1, 2)), lr


def _port_server(sv, cv, batch=4, wait=20.0):
    return PipelineServer(_port_pipeline(sv, cv), batch_size=batch,
                          max_wait_ms=wait)


def test_every_endpoint_and_status_code(nets):
    sv, cv, lr = nets
    served = _Served(make_http_server, _port_server(sv, cv),
                     config={"sr_mode": "f32"})
    try:
        status, ctype, body = _request(served.base + "/healthz")
        health = json.loads(body)
        assert status == 200 and ctype == "application/json"
        assert health == {"status": "ok", "config": {"sr_mode": "f32",
                                                     "lr_h": LR, "lr_w": LR}}
        req = png.encode_png(lr[0])
        status, _, body = _request(served.base + "/classify", req)
        r = json.loads(body)
        assert status == 200 and r["class"] in (0, 1)
        assert 0.0 <= r["confidence"] <= 1.0
        status, ctype, sr_png = _request(served.base + "/sr", req)
        assert status == 200 and ctype == "image/png"
        assert png.decode_png_u8(sr_png).shape == (LR * SCALE, LR * SCALE, 3)
        status, _, body = _request(served.base + "/classify_sr", req)
        both = json.loads(body)
        assert status == 200 and both["class"] == r["class"]
        assert base64.b64decode(both["sr_png_base64"]) == sr_png
        # a progressive JPEG answers 200; 400: not an image, an
        # arithmetic-coded JPEG, a GIF, a wrong LR size
        ok, jpg = cv2.imencode(".jpg", (lr[0] * 255).astype(np.uint8),
                               [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        status, ctype, _ = _request(served.base + "/sr", jpg.tobytes())
        assert status == 200 and ctype == "image/png"
        status, _, body = _request(served.base + "/classify", b"not an image")
        assert status == 400 and json.loads(body)["type"] == "ValueError"
        ok, jpg = cv2.imencode(".jpg", (lr[0] * 255).astype(np.uint8))
        i = jpg.tobytes().index(b"\xff\xc0")
        arith = jpg.tobytes()[:i + 1] + b"\xc9" + jpg.tobytes()[i + 2:]
        status, _, body = _request(served.base + "/sr", arith)
        assert status == 400 and "arithmetic-coded JPEG" in json.loads(
            body)["error"]
        status, _, body = _request(served.base + "/sr", b"GIF89a" + b"\0" * 16)
        assert status == 400 and "GIF" in json.loads(body)["error"]
        status, _, body = _request(served.base + "/classify",
                                   png.encode_png(np.zeros((LR + 1, LR, 3))))
        assert status == 400 and "expected" in json.loads(body)["error"]
        # 404: any other path, POST or GET
        assert _request(served.base + "/nope", req)[0] == 404
        assert _request(served.base + "/nope")[0] == 404
    finally:
        served.close()


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_a_jpeg_body_is_served_as_its_cv2_decode(nets, sampling):
    """A baseline JPEG request body answers 200 with the classes, the
    confidences and the SR of its cv2 decode sent as a PNG."""
    sv, cv, lr = nets
    factor = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
              "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}[sampling]
    served = _Served(make_http_server, _port_server(sv, cv))
    try:
        for img in lr[:3]:
            rgb = (img * 255).astype(np.uint8)
            ok, jpg = cv2.imencode(".jpg", rgb[..., ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, 85,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
            assert ok
            twin = png.encode_png_u8(_cv2_rgb(jpg.tobytes()))
            for path in ("/classify", "/sr"):
                got = _request(served.base + path, jpg.tobytes())
                want = _request(served.base + path, twin)
                assert got[0] == want[0] == 200
                assert got[2] == want[2]
    finally:
        served.close()


def test_a_body_of_another_size_is_refused_from_its_header(monkeypatch):
    """A JPEG or PNG whose header declares another size than the LR size
    answers 400 before any of its data is decoded: a body of a few hundred
    bytes that declares a huge frame costs the server nothing."""
    from tpusr_torch.pipeline import jpeg
    scans = []

    def no_scan(*a):
        scans.append(1)
        raise AssertionError("a scan was decoded")
    monkeypatch.setattr(jpeg, "_decode_scan", no_scan)
    monkeypatch.setattr(png, "_unfilter", no_scan)

    def never(imgs):
        raise AssertionError("no request reaches the pipeline")

    served = _Served(make_http_server, PipelineServer(never, batch_size=1))
    try:
        ok, jpg = cv2.imencode(".jpg", np.zeros((16, 16), np.uint8))
        assert ok
        i = jpg.tobytes().index(b"\xff\xc0")
        for h, w, what in ((65535, 65535, "over 2^30 pixels"),
                           (8192, 8192, f"expected {LR}x{LR} LR input"),
                           (LR + 1, LR, f"expected {LR}x{LR} LR input")):
            body = (jpg.tobytes()[:i + 5] + struct.pack(">HH", h, w)
                    + jpg.tobytes()[i + 9:])
            status, _, reply = _request(served.base + "/classify", body)
            assert status == 400 and what in json.loads(reply)["error"]
        status, _, reply = _request(served.base + "/sr", png.encode_png_u8(
            np.zeros((8192, 8, 3), np.uint8)))
        assert status == 400
        assert f"expected {LR}x{LR} LR input" in json.loads(reply)["error"]
        assert not scans
    finally:
        served.close()


def test_504_when_the_batcher_misses_the_deadline():
    def slow(imgs):
        time.sleep(2.0)
        raise AssertionError("unreachable in this test's deadline")

    served = _Served(make_http_server, PipelineServer(slow, batch_size=1),
                     request_timeout=0.2)
    try:
        status, _, body = _request(served.base + "/classify",
                                   png.encode_png(np.zeros((LR, LR, 3))))
        assert status == 504
        assert json.loads(body)["type"] == "TimeoutError"
    finally:
        served.close()


def test_500_on_a_pipeline_fault():
    def broken(imgs):
        raise RuntimeError("pipeline fault")

    served = _Served(make_http_server, PipelineServer(broken, batch_size=2,
                                                      max_wait_ms=1))
    try:
        status, _, body = _request(served.base + "/classify_sr",
                                   png.encode_png(np.zeros((LR, LR, 3))))
        assert status == 500
        assert json.loads(body) == {"error": "pipeline fault",
                                    "type": "RuntimeError"}
    finally:
        served.close()


def test_max_requests_shuts_the_server_down(nets):
    sv, cv, lr = nets
    server = _port_server(sv, cv, batch=2, wait=1.0).start()
    httpd = make_http_server(server, (LR, LR), port=0, max_requests=3)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = png.encode_png(lr[1])
        assert _request(base + "/healthz")[0] == 200      # GETs do not count
        assert _request(base + "/nope", req)[0] == 404    # nor unknown paths
        assert _request(base + "/classify", req)[0] == 200
        assert _request(base + "/classify", b"bad")[0] == 400  # a 400 counts
        assert thread.is_alive()
        assert _request(base + "/sr", req)[0] == 200
        thread.join(timeout=30)
        assert not thread.is_alive()
    finally:
        httpd.server_close()
        server.stop()


def test_http_answers_match_the_jax_server(nets, monkeypatch):
    import tpusr.models.vgg as jvgg
    sv, cv, lr = nets
    # flax checks the tree's widths against the declared features
    monkeypatch.setattr(jvgg, "_VGG16_CFG", tuple(
        (b, n, w) for (b, n, _f), w in zip(jvgg._VGG16_CFG, NARROW_WIDTHS)))
    port = _Served(make_http_server, _port_server(sv, cv, batch=4, wait=5.0))
    jax_pipe = jax_make_pipeline(sv, cv, (LR, LR), SCALE, patch=PATCH,
                                 stride=STRIDE, sr_mode="f32",
                                 clf_mode="per_patch_f32")
    jax = _Served(jax_make_http, JaxPipelineServer(jax_pipe, batch_size=4,
                                                   max_wait_ms=5.0))
    try:
        classes = []
        for im in lr:
            body = png.encode_png(im)
            got = [json.loads(_request(s.base + "/classify", body)[2])
                   for s in (port, jax)]
            assert got[0]["class"] == got[1]["class"]
            assert abs(got[0]["confidence"] - got[1]["confidence"]) <= 1e-5
            classes.append(got[0]["class"])
            srs = [_request(s.base + "/sr", body)[2] for s in (port, jax)]
            a, b = png.decode_png_u8(srs[0]), _cv2_rgb(srs[1])
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert set(classes) == {0, 1}   # both classes answered
    finally:
        port.close()
        jax.close()


def _bodies(u8: np.ndarray) -> dict:
    """The LR image in each format the port reads beside PNG."""
    ok, bmp = cv2.imencode(".bmp", u8[..., ::-1])
    ok2, prog = cv2.imencode(".jpg", u8[..., ::-1], [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok and ok2
    out = {"bmp": bmp.tobytes(),
           "tiff": write_tiff(u8, compression=8, predictor=2),
           "progressive": prog.tobytes(),
           "adam7": write_png(u8, 8, 2, interlace=1)}
    for name, ext in (("webp-lossy", ".webp"), ("ppm", ".ppm"),
                      ("pam", ".pam"), ("hdr", ".hdr")):
        img = u8[..., ::-1] if ext != ".hdr" \
            else u8[..., ::-1].astype(np.float32) / 255
        ok, buf = cv2.imencode(ext, img)
        assert ok
        out[name] = buf.tobytes()
    for name, kw in (("webp-lossless", dict(format="WEBP", lossless=True)),
                     ("gif", dict(format="GIF"))):
        buf = io.BytesIO()
        Image.fromarray(u8).save(buf, **kw)
        out[name] = buf.getvalue()
    h, w, _ = u8.shape
    out["sun-raster"] = write_sunras(w, h, 24, sunras_rows(u8[..., ::-1], 24))
    out["pfm"] = write_pfm(u8.astype(np.float32))
    return out


def _unread_bodies(u8: np.ndarray) -> dict:
    """Bodies of formats the port refuses by name, by that name."""
    jp2, avif = io.BytesIO(), io.BytesIO()
    Image.fromarray(u8).save(jp2, "JPEG2000")
    Image.fromarray(u8).save(avif, "AVIF")
    ok, jpg = cv2.imencode(".jpg", u8)
    i = jpg.tobytes().index(b"\xff\xc0")
    return {"JPEG 2000": jp2.getvalue(), "AVIF": avif.getvalue(),
            "OpenEXR": b"v/1\x01" + bytes(60),
            "arithmetic-coded JPEG": jpg.tobytes()[:i + 1] + b"\xc9"
            + jpg.tobytes()[i + 2:]}


def test_http_tier_answers_each_format_as_its_png_twin(nets):
    """BMP, TIFF, progressive-JPEG, Adam7, WebP (lossy and lossless), GIF,
    PPM, PAM, Sun raster, HDR and PFM bodies answer 200 with the class and
    the SR of their PNG twins; JPEG 2000, AVIF, OpenEXR and
    arithmetic-coded JPEG bodies answer 400 naming what they are; a body of
    another size in a new format is refused from its header."""
    sv, cv, lr = nets
    served = _Served(make_http_server, _port_server(sv, cv))
    try:
        for img in lr[:2]:
            u8 = (img * 255).astype(np.uint8)
            for name, body in _bodies(u8).items():
                bgr = cv2.imdecode(np.frombuffer(body, np.uint8),
                                   cv2.IMREAD_COLOR)
                twin = png.encode_png_u8(np.ascontiguousarray(
                    cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
                for path in ("/classify", "/sr"):
                    got = _request(served.base + path, body)
                    want = _request(served.base + path, twin)
                    assert got[0] == want[0] == 200, (name, path, got[2][:200])
                    assert got[2] == want[2], (name, path)
        u8 = (lr[0] * 255).astype(np.uint8)
        for what, body in _unread_bodies(u8).items():
            status, _, reply = _request(served.base + "/classify", body)
            assert status == 400 and what in json.loads(reply)["error"]
        # a body of another size in a new format is refused from its header
        wide = np.zeros((LR, LR + 1, 3), np.uint8)
        for name, body in _bodies(wide).items():
            status, _, reply = _request(served.base + "/sr", body)
            assert status == 400 and "expected" in json.loads(reply)["error"]
    finally:
        served.close()


def test_new_formats_decode_as_the_jax_server_decodes(nets, monkeypatch):
    """Each format the HTTP tier reads beside PNG decodes to the array of
    the JAX server's ``_decode_image`` (``cv2.imdecode`` + ``cvtColor``),
    exactly; through both servers on the same weights each answers the
    same class. OpenEXR, which this cv2 cannot read, is a 400 from both;
    JPEG 2000 and AVIF are 400s naming themselves from the port only."""
    import tpusr.models.vgg as jvgg
    from tpusr.pipeline.http_serving import _decode_image as jax_decode

    from tpusr_torch.pipeline.imdecode import decode_image
    sv, cv, lr = nets
    u8 = (lr[0] * 255).astype(np.uint8)
    for name, body in _bodies(u8).items():
        np.testing.assert_array_equal(decode_image(body), jax_decode(body),
                                      err_msg=name)
    for what, body in _unread_bodies(u8).items():
        with pytest.raises(ValueError, match=what):
            decode_image(body)
    with pytest.raises(ValueError):
        jax_decode(_unread_bodies(u8)["OpenEXR"])
    monkeypatch.setattr(jvgg, "_VGG16_CFG", tuple(
        (b, n, w) for (b, n, _f), w in zip(jvgg._VGG16_CFG, NARROW_WIDTHS)))
    port = _Served(make_http_server, _port_server(sv, cv, batch=4, wait=5.0))
    jax_pipe = jax_make_pipeline(sv, cv, (LR, LR), SCALE, patch=PATCH,
                                 stride=STRIDE, sr_mode="f32",
                                 clf_mode="per_patch_f32")
    jax = _Served(jax_make_http, JaxPipelineServer(jax_pipe, batch_size=4,
                                                   max_wait_ms=5.0))
    try:
        bodies = _bodies(u8)
        for name in ("webp-lossy", "webp-lossless", "gif", "ppm", "hdr"):
            got = [_request(s.base + "/classify", bodies[name])
                   for s in (port, jax)]
            assert got[0][0] == got[1][0] == 200, name
            assert json.loads(got[0][2])["class"] == \
                json.loads(got[1][2])["class"], name
        exr = _unread_bodies(u8)["OpenEXR"]
        assert [_request(s.base + "/classify", exr)[0]
                for s in (port, jax)] == [400, 400]
    finally:
        port.close()
        jax.close()
