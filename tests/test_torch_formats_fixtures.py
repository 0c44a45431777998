"""The committed image-format fixtures (``tests/data/formats``) that the
card's smoke run decodes (that machine has no OpenCV): each file is the one
``manifest.json`` names, its cv2 decode is what cv2 gives now, and the
port's decode (``pipeline/imdecode.py``) equals it byte for byte.
``python tests/data/formats/make_fixtures.py`` rewrites them.
"""

import hashlib
import json
import lzma
import os

import cv2
import numpy as np
import pytest

from tpusr_torch.pipeline.imdecode import decode_image_u8, image_format

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "formats")
with open(os.path.join(DATA, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def test_the_manifest_lists_every_fixture_and_they_stay_small():
    files = sorted(f for f in os.listdir(DATA)
                   if f not in ("manifest.json", "make_fixtures.py"))
    assert files == sorted(MANIFEST)
    assert sum(os.path.getsize(os.path.join(DATA, f)) for f in files) \
        < 1_500_000
    kinds = {image_format(_body(f)) for f in files}
    assert kinds == {"PNG", "JPEG", "BMP", "TIFF", "WebP", "GIF", "PNM",
                     "Sun raster", "HDR", "PFM"}
    assert sum(f.startswith("lr") for f in files) == 16 + 14
    assert sum(f.startswith("s512") for f in files) == 8 + 3


def _body(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        stored = f.read()
    return lzma.decompress(stored) if name.endswith(".xz") else stored


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_its_cv2_manifest_entry(name):
    want = MANIFEST[name]
    with open(os.path.join(DATA, name), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == want["file_sha256"]
    body = _body(name)
    bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    assert list(rgb.shape) == want["shape"]
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(decode_image_u8(body), rgb)


SERVED_KINDS = ("WebP", "GIF", "PNM", "Sun raster", "HDR", "PFM")


@pytest.mark.parametrize("kind", SERVED_KINDS)
def test_corrupt_bodies_are_refused_or_decoded_as_cv2_decodes(kind):
    """Bodies of the formats only the HTTP tier reads, cut short or with
    bytes changed (seeded): the port raises ``ValueError`` where cv2
    returns nothing (or raises) and otherwise equals its decode; nothing
    else is raised."""
    rng = np.random.default_rng(SERVED_KINDS.index(kind))
    names = [n for n in sorted(MANIFEST) if n.startswith("edge_")
             and image_format(_body(n)) == kind]
    assert names
    for _ in range(40):
        b = bytearray(_body(names[rng.integers(0, len(names))]))
        if rng.random() < 0.3:
            b = b[:rng.integers(1, len(b))]
        else:
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(0, len(b))] = rng.integers(0, 256)
        b = bytes(b)
        try:
            want = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
        except cv2.error:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                decode_image_u8(b)
            continue
        want = np.repeat(want[..., None], 3, 2) if want.ndim == 2 \
            else want[..., ::-1]
        np.testing.assert_array_equal(decode_image_u8(b), want)
