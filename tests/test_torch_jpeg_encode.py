"""The port's baseline JPEG encoder (``tpusr_torch/pipeline/jpeg_encode.py``)
against ``cv2.imencode(".jpeg", bgr, [IMWRITE_JPEG_QUALITY, q])``
(libjpeg-turbo with OpenCV's settings): the bytes, byte for byte, at the
degradation's qualities and the extremes, on sides that are and are not
multiples of the 16-pixel MCU; and the committed fixtures under
``tests/data/video/`` (``make_fixtures.py``), which ``chip_smoke.py`` holds
the encoder to on a machine without OpenCV.
"""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
from tpusr_torch.pipeline.jpeg_encode import encode_jpeg_u8, quant_table

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "video")
QUALITIES = (1, 20, 37, 59, 75, 100)
SIZES = ((1, 1), (8, 8), (17, 23), (24, 24), (256, 256), (23, 17), (48, 40))


def _images(h, w):
    """A noisy and a smooth RGB image of h x w."""
    rng = np.random.default_rng(h * 1000 + w)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(127 + 120 * np.sin(xx / 7.0 + yy / 11.0 + k))
                       for k in range(3)], -1).astype(np.uint8)
    return noise, smooth


def _cv2_bytes(rgb, q=None):
    params = [] if q is None else [cv2.IMWRITE_JPEG_QUALITY, q]
    ok, out = cv2.imencode(".jpeg", np.ascontiguousarray(rgb[..., ::-1]), params)
    assert ok
    return out.tobytes()


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("quality", QUALITIES)
def test_bytes_equal_cv2_imencode(h, w, quality):
    for img in _images(h, w):
        assert encode_jpeg_u8(img, quality) == _cv2_bytes(img, quality)


def test_default_quality_is_opencvs_95():
    img = _images(40, 56)[0]
    assert encode_jpeg_u8(img) == _cv2_bytes(img)


def test_quality_scaling_clamps_the_tables_to_baseline():
    from tpusr_torch.pipeline.jpeg_encode import _STD_LUMA
    assert quant_table(_STD_LUMA, 100).tolist() == [1] * 64
    assert quant_table(_STD_LUMA, 1).max() == 255
    assert quant_table(_STD_LUMA, 50).tolist() == _STD_LUMA.tolist()


def test_flat_and_saturated_images_equal_cv2():
    for v in (0, 128, 255):
        img = np.full((33, 47, 3), v, np.uint8)
        for q in (20, 95):
            assert encode_jpeg_u8(img, q) == _cv2_bytes(img, q)


def test_committed_fixtures_equal_the_encoder():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["encode"]
    for size, entry in manifest.items():
        bgr = cv2.imread(os.path.join(FIXTURES, f"enc_{size}.png"))
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == entry["input_sha256"]
        for q, digest in entry["jpeg_sha256"].items():
            with open(os.path.join(FIXTURES, f"enc_{size}_q{q}.jpg"), "rb") as f:
                want = f.read()
            assert hashlib.sha256(want).hexdigest() == digest
            assert encode_jpeg_u8(rgb, int(q)) == want


def test_round_trip_through_the_decoder_equals_cv2():
    img = _images(37, 53)[1]
    for q in (20, 59):
        got = decode_jpeg_u8(encode_jpeg_u8(img, q))
        want = cv2.imdecode(np.frombuffer(_cv2_bytes(img, q), np.uint8), 1)
        np.testing.assert_array_equal(got, want[..., ::-1])


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 3), np.float32),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((0, 4, 3), np.uint8)])
def test_refuses_what_it_cannot_encode(bad):
    with pytest.raises(ValueError):
        encode_jpeg_u8(bad, 50)
