"""WebP through the port's decoder (``pipeline/webp.py``, ``vp8.py``,
``vp8l.py``) against ``cv2.imdecode(IMREAD_COLOR)`` byte for byte: cv2's
lossy files at several qualities and sizes (the fancy upsampler at odd
sizes), Pillow's lossy and lossless methods, VP8 key frames written by hand
under every header tool (``vp8_frame``), alpha raw and compressed under
each filter (equal to ``IMREAD_UNCHANGED``'s alpha, and dropped without
blending under ``IMREAD_COLOR``), an animation's first frame, metadata
chunks, and what cv2 refuses, refused by name. The committed fixtures are
``test_torch_formats_fixtures.py``'s; here their manifest's tool counts
are held to cover every tool.
"""

import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_image_writers import riff_chunk, vp8_frame, webp_file
from tpusr_torch.pipeline import imdecode, vp8
from tpusr_torch.pipeline.webp import decode_webp

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "formats")


def _scene(seed, h, w, noise=12.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    x = np.stack([127 + 100 * np.sin(xx / 7 + k + yy / 11) for k in range(3)],
                 -1) + rng.normal(scale=noise, size=(h, w, 3))
    return np.clip(x, 0, 255).astype(np.uint8)


def _cv2(body: bytes, flags=cv2.IMREAD_COLOR):
    return cv2.imdecode(np.frombuffer(body, np.uint8), flags)


def _same_as_cv2(body: bytes):
    want = _cv2(body)
    assert want is not None
    np.testing.assert_array_equal(imdecode.decode_image_u8(body),
                                  want[..., ::-1])


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("hw", [(1, 1), (1, 2), (2, 1), (3, 3), (5, 8),
                                (17, 9), (16, 16), (33, 47)])
def test_cv2_lossy_at_every_quality_band_and_odd_size(hw):
    """The 4:2:0 upsampler's first and last rows and columns at odd and
    even sizes, over qualities 1-100 (the 128^2 and 512^2 sizes are the
    committed fixtures)."""
    img = _scene(sum(hw), *hw)
    for q in (1, 30, 75, 100):
        ok, buf = cv2.imencode(".webp", img[..., ::-1],
                               [cv2.IMWRITE_WEBP_QUALITY, q])
        assert ok
        _same_as_cv2(buf.tobytes())


@pytest.mark.parametrize("kw", [dict(quality=80, method=0),
                                dict(quality=40, method=6),
                                dict(lossless=True, method=0),
                                dict(lossless=True, method=3, quality=50),
                                dict(lossless=True, method=6, quality=100)],
                         ids=["lossy-m0", "lossy-m6", "lossless-m0",
                              "lossless-m3", "lossless-m6"])
def test_pillow_methods(kw):
    _same_as_cv2(_pil(_scene(4, 40, 33), **kw))


@pytest.mark.parametrize("n", [2, 3, 5, 16, 17, 256])
def test_lossless_palettes_and_pixel_bundling(n):
    """Colour indexing at 1, 2, 4 and 8 bits an index (bundled 8, 4, 2, 1
    to a pixel) at a width no bundle divides."""
    rng = np.random.default_rng(n)
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    _same_as_cv2(_pil(pal[rng.integers(0, n, (21, 29))], lossless=True))


VP8_HEADERS = {
    "normal": dict(),
    "simple": dict(filter_type="simple", level=35),
    "sharpness": dict(sharpness=5, level=40),
    "simple-sharp": dict(filter_type="simple", level=63, sharpness=7),
    "no-filter": dict(level=0),
    "partitions-2": dict(partitions=2),
    "partitions-4": dict(partitions=4),
    "partitions-8": dict(partitions=8),
    "segments-delta": dict(segments=dict(quant=[5, -10, 20, 0],
                                         lf=[3, -5, 10, 0],
                                         map_probs=[100, 150, 200])),
    "segments-absolute": dict(segments=dict(quant=[50, 10, 90, 3],
                                            lf=[30, 5, 63, 0], absolute=True,
                                            map_probs=[10, 250, 128])),
    "segments-no-map": dict(segments=dict(quant=[5, -10, 20, 0],
                                          lf=[3, -5, 10, 0])),
    "lf-deltas": dict(lf_delta=([4, 0, 0, 0], [-6, 0, 0, 0])),
    "q-deltas": dict(q_deltas=(3, -4, 5, 8, -2)),
    "prob-updates": dict(prob_updates=0.1),
    "skip": dict(skip_prob=100),
    "q0-large-tokens": dict(q_index=0, big=0.3),
    "q127": dict(q_index=127, big=0.3),
    "i16-only": dict(i16_share=1.0),
    "b-pred-only": dict(i16_share=0.0, coef_share=0.9),
}


@pytest.mark.parametrize("name", sorted(VP8_HEADERS))
def test_hand_written_vp8_frames_under_every_header_tool(name):
    """Random modes and coefficients under each header tool no encoder at
    hand writes, at a size that crops its last macroblocks."""
    rng = np.random.default_rng(sorted(VP8_HEADERS).index(name))
    for w, h in ((33, 17), (48, 48)):
        frame = vp8_frame(rng, w, h, **VP8_HEADERS[name])
        _same_as_cv2(webp_file([(b"VP8 ", frame)]))


def _alpha_stream(alpha: np.ndarray) -> bytes:
    g = np.zeros((*alpha.shape, 3), np.uint8)
    g[..., 1] = alpha
    body = _pil(g, lossless=True)
    return body[body.index(b"VP8L") + 8 + 5:]


@pytest.mark.parametrize("method,filt", [(m, f) for m in (0, 1)
                                         for f in range(4)])
def test_alpha_plane_equals_cv2s_and_is_dropped_under_imread_color(method,
                                                                    filt):
    """An ``ALPH`` chunk raw or VP8L-compressed under each filter: the
    port's alpha equals ``IMREAD_UNCHANGED``'s fourth channel, and
    ``IMREAD_COLOR`` is its first three, unblended."""
    rng = np.random.default_rng(4 * method + filt)
    alpha = rng.integers(0, 256, (19, 27), np.uint8)
    data = alpha.tobytes() if method == 0 else _alpha_stream(alpha)
    body = webp_file([(b"ALPH", bytes([method | filt << 2]) + data),
                      (b"VP8 ", vp8_frame(rng, 27, 19))], vp8x=(0x10, 27, 19))
    rgb, a = decode_webp(body)
    bgra = _cv2(body, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(a, bgra[..., 3])
    np.testing.assert_array_equal(rgb, bgra[..., 2::-1])
    np.testing.assert_array_equal(rgb, _cv2(body)[..., ::-1])


@pytest.mark.parametrize("kw", [dict(quality=70), dict(lossless=True,
                                                        exact=True)],
                         ids=["lossy", "lossless"])
def test_pillow_alpha_equals_imread_unchanged(kw):
    img = np.dstack([_scene(5, 23, 31), np.random.default_rng(5).integers(
        0, 256, (23, 31), np.uint8)])
    body = _pil(img, **kw)
    rgb, a = decode_webp(body)
    bgra = _cv2(body, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(a, bgra[..., 3])
    np.testing.assert_array_equal(rgb, bgra[..., 2::-1])
    _same_as_cv2(body)


def _chunks(body: bytes):
    out, pos = [], 12
    while pos + 8 <= len(body):
        n = struct.unpack("<I", body[pos + 4:pos + 8])[0]
        out.append((body[pos:pos + 4], body[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _anmf(x, y, img, **kw) -> bytes:
    h, w = img.shape[:2]
    head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
            + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
            + (50).to_bytes(3, "little") + b"\0")
    return head + b"".join(riff_chunk(t, d)
                           for t, d in _chunks(_pil(img, **kw))
                           if t != b"VP8X")


@pytest.mark.parametrize("kw", [dict(quality=60), dict(lossless=True,
                                                        exact=True)],
                         ids=["lossy", "lossless"])
def test_animation_first_frame_as_webp_anim_decoder_composes_it(kw):
    """The first frame's colour at its offset on a black canvas; the
    background colour and the later frames play no part."""
    rng = np.random.default_rng(6)
    first = np.dstack([_scene(6, 14, 18), rng.integers(0, 256, (14, 18),
                                                       np.uint8)])
    body = webp_file([(b"ANIM", bytes([9, 200, 30, 255, 0, 0])),
                      (b"ANMF", _anmf(6, 4, first, **kw)),
                      (b"ANMF", _anmf(0, 0, _scene(7, 25, 31), **kw))],
                     vp8x=(0x12, 31, 25))
    _same_as_cv2(body)
    assert not imdecode.decode_image_u8(body)[:4].any()


def test_metadata_chunks_and_bytes_past_the_riff_size_are_skipped():
    img = _scene(8, 21, 26)
    body = _pil(img, quality=60, exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0",
                xmp=b"<x:xmpmeta/>", icc_profile=b"\0" * 40)
    assert {t for t, _ in _chunks(body)} >= {b"VP8X", b"EXIF", b"XMP ",
                                             b"ICCP"}
    _same_as_cv2(body)
    _same_as_cv2(_pil(img, lossless=True) + b"trailing junk")


def _lossy(w=24, h=20) -> bytes:
    return webp_file([(b"VP8 ", vp8_frame(np.random.default_rng(9), w, h))])


def _refusals():
    good = _lossy()
    frame = good[20:]
    tiny = cv2.imencode(".webp", np.zeros((1, 1, 3), np.uint8))[1].tobytes()
    lossless = _pil(_scene(9, 9, 9), lossless=True)
    return {
        "under 32 bytes": (tiny[:31], "under 32"),
        "riff size past the body": (good[:4] + struct.pack(
            "<I", len(good)) + good[8:], "RIFF size"),
        "unknown first chunk": (good[:12] + b"VP9 " + good[16:], "VP9"),
        "interframe": (good[:20] + bytes([frame[0] | 1]) + good[21:],
                       "interframe"),
        "bad start code": (good[:23] + b"\x9d\x01\x2b" + good[26:],
                           "start code"),
        "invisible frame": (good[:20] + bytes([frame[0] & ~0x10])
                            + good[21:], "displayable"),
        "canvas differs": (webp_file([(b"VP8 ", frame)], vp8x=(0, 25, 20)),
                           "canvas"),
        "alpha header": (webp_file([(b"ALPH", b"\xc0" + bytes(480)),
                                    (b"VP8 ", frame)], vp8x=(0x10, 24, 20)),
                         "ALPH header"),
        "alpha truncated": (webp_file([(b"ALPH", b"\x00" + bytes(100)),
                                       (b"VP8 ", frame)],
                                      vp8x=(0x10, 24, 20)), "ALPH plane"),
        "vp8l version": (lossless[:24] + bytes([lossless[24] | 0x20])
                         + lossless[25:], "version"),
        "vp8l truncated": (webp_file([(b"VP8L", lossless[20:len(lossless)
                                                         // 2])]),
                           "ends early"),
        "first partition truncated": (webp_file([(b"VP8 ", frame[:14])]),
                                      "partition"),
        "token partition empty": (webp_file([(b"VP8 ", frame[:10 + (
            int.from_bytes(frame[:3], "little") >> 5)])]), "partition"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_what_cv2_refuses_is_refused_by_name(case):
    body, what = _refusals()[case]
    assert _cv2(body) is None
    with pytest.raises(ValueError, match=what):
        imdecode.decode_image_u8(body)


def test_expected_size_is_refused_from_the_header():
    with pytest.raises(ValueError, match="expected"):
        imdecode.decode_image_u8(_lossy(), expected_hw=(21, 24))
    np.testing.assert_array_equal(
        imdecode.decode_image_u8(_lossy(), expected_hw=(20, 24)),
        _cv2(_lossy())[..., ::-1])


def test_the_manifest_tool_counts_cover_every_tool():
    """The committed WebP fixtures use every VP8 intra mode (16x16, the ten
    4x4 and the chroma ones), the simple and normal loop filters and none,
    1-8 partitions, segment maps, filter and quantiser deltas, skipped
    macroblocks; all four lossless transforms, the colour cache and meta
    codes; raw and compressed alpha; an animation."""
    with open(os.path.join(DATA, "manifest.json")) as f:
        tools = [v["tools"] for v in json.load(f).values() if "tools" in v]
    lossy = [t for t in tools if t["codec"] == "lossy"]
    lossless = [t for t in tools if t["codec"] == "lossless"]
    for key, modes in (("i16", vp8.MODE_NAMES[:4]), ("b_pred", vp8.MODE_NAMES),
                       ("uv", vp8.MODE_NAMES[:4])):
        assert {m for t in lossy for m in t[key]} == set(modes), key
    assert {t["filter"] for t in lossy} == {"none", "simple", "normal"}
    assert {t["partitions"] for t in lossy} == {1, 2, 4, 8}
    assert max(t["segments"] for t in lossy) == 4
    assert any(t["lf_delta"] for t in lossy)
    assert any(t["sharpness"] for t in lossy)
    assert any(t["skipped"] for t in lossy)
    assert {x for t in lossless for x in t["transforms"]} == {
        "predictor", "cross-colour", "subtract-green", "colour-indexing"}
    assert any(t["cache_bits"] for t in lossless)
    assert any(t["meta_bits"] for t in lossless)
    assert {t["alpha"]["method"] for t in tools if "alpha" in t} == {0, 1}
    assert any(t.get("animation") for t in tools)
