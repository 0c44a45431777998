"""PBM/PGM/PPM/PAM, Sun raster, Radiance HDR and PFM through the port's
decoders (``pipeline/pnm.py``, ``sunras.py``, ``hdr.py``) against
``cv2.imdecode(IMREAD_COLOR)`` byte for byte, on cv2's own files and on
files written by hand for what cv2 does not write: ASCII and binary at 1,
8 and 16 bits, comments and odd whitespace, ``maxval`` scaling (ASCII) and
its absence (binary), PAM tuple types and its bit mode; Sun raster depths
and colour maps; HDR headers, flat and RLE scanlines and the switch to
flat; PFM byte orders, scales and non-finite values. What cv2 refuses is
refused; what cv2 decodes to uninitialised memory (PAM with alpha) or
refuses silently (Sun raster RLE and RGB types) is refused by name. HDR
holds cv2's x255 and PFM its absence.
"""

import cv2
import numpy as np
import pytest

from torch_image_writers import sunras_rows, write_hdr, write_pfm, write_sunras
from tpusr_torch.pipeline import imdecode

RNG = np.random.default_rng(21)
IMG = RNG.integers(0, 256, (7, 13, 3), np.uint8)


def _held_to_cv2(body: bytes):
    """Equal to cv2's decode (a one-channel one repeated, as the JAX
    server's ``cvtColor`` repeats it), or refused where cv2 returns
    nothing."""
    want = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if want is None:
        with pytest.raises(ValueError):
            imdecode.decode_image_u8(body)
        return None
    want = np.repeat(want[..., None], 3, 2) if want.ndim == 2 \
        else want[..., ::-1]
    got = imdecode.decode_image_u8(body)
    np.testing.assert_array_equal(got, want)
    return got


def _cv2_file(ext, img):
    ok, buf = cv2.imencode(ext, img)
    assert ok
    return buf.tobytes()


G = RNG.integers(0, 16, (2, 3), np.uint8)
PNM = {
    "cv2-ppm": (_cv2_file(".ppm", IMG), True),
    "cv2-pgm": (_cv2_file(".pgm", IMG[..., 0]), True),
    "cv2-pam": (_cv2_file(".pam", IMG), True),
    "p5-maxval-15-raw": (b"P5 3 2 15\n" + G.tobytes(), True),
    "p2-maxval-15-scaled": (b"P2 3 2 15\n0 5 15 7 10 3\n", True),
    "p2-over-maxval-clamped": (b"P2 3 2 15\n0 5 99 7 10 3\n", True),
    "p2-16-bit": (b"P2 3 2 1000\n0 500 1000 700 999 3\n", True),
    "p5-16-bit": (b"P5 3 1 1000\n" + np.array([0, 500, 1000], ">u2")
                  .tobytes(), True),
    "p1": (b"P1\n3 2\n0 1 0\n1 1 0\n", True),
    "p1-unspaced": (b"P1\n3 2\n010110\n", True),
    "p4-odd-width": (b"P4\n11 2\n" + bytes([0b01000000, 0b11100000,
                                              0b10101010, 0b00100000]), True),
    "p3": (b"P3\n2 1\n255\n10 20 30 40 50 60\n", True),
    "p6-maxval-100": (b"P6\n2 1\n100\n" + bytes(range(10, 70, 10)), True),
    "p6-16-bit": (b"P6 2 1 4095\n" + np.arange(6, dtype=">u2").tobytes()
                  * 300, True),
    "comments": (b"P5\n# a\n3 # b\n2\n15\n" + G.tobytes(), True),
    "comment-cr": (b"P5\n#c\r3 2 15\n" + G.tobytes(), True),
    "tabs": (b"P5\t3\t2\t15\t" + G.tobytes(), True),
    "crlf-eats-lf": (b"P5 3 2 15\r\n" + G.tobytes(), True),
    "bytes-after": (b"P5 3 2 15\n" + G.tobytes() + b"xx", True),
    "pam-rgb-reversed": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\n"
                         b"TUPLTYPE RGB\nENDHDR\n" + bytes(range(18)), True),
    "pam-no-tupltype": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\n"
                        b"ENDHDR\n" + bytes(range(18)), True),
    "pam-gray16": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 65535\n"
                   b"TUPLTYPE GRAYSCALE\nENDHDR\n" + bytes(range(12)), True),
    "pam-rgb16": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 1000\n"
                  b"TUPLTYPE RGB\nENDHDR\n" + bytes(range(36)), True),
    "pam-bit-mode": (b"P7\nWIDTH 9\nHEIGHT 1\nDEPTH 1\nMAXVAL 1\n"
                     b"TUPLTYPE BLACKANDWHITE\nENDHDR\n"
                     + bytes([0xAA, 0x80] + [0] * 7), True),
    "pam-bit-mode-rgb": (b"P7\nWIDTH 3\nHEIGHT 1\nDEPTH 3\nMAXVAL 1\n"
                         b"TUPLTYPE RGB\nENDHDR\n" + bytes([0xA0] + [0] * 8),
                         True),
    "pam-header-spacing": (b"P7\n\n  WIDTH  3 \n# c\nHEIGHT 2\r\nDEPTH 1\n"
                           b"MAXVAL 100\nENDHDR\r\n" + bytes(range(7)), True),
    # refused
    "p2-no-terminator": (b"P2 3 2 15\n0 5 15 7 10 3", False),
    "p2-no-terminator-after-digits": (b"P2 3 2 99\n0 5 15 7 10 33", False),
    "p2-letter": (b"P2 3 2 15\n0 5 x 7 10 3\n", False),
    "p5-maxval-0": (b"P5 3 2 0\n" + G.tobytes(), False),
    "p5-maxval-65536": (b"P5 3 2 65536\n" + G.tobytes() * 2, False),
    "p5-short": (b"P5 3 2 15\n" + G.tobytes()[:5], False),
    "pam-unknown-tupltype": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\n"
                             b"TUPLTYPE FOO\nENDHDR\n" + bytes(18), False),
    "pam-depth-mismatch": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\n"
                           b"TUPLTYPE RGB\nENDHDR\n" + bytes(6), False),
    "pam-missing-maxval": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nENDHDR\n"
                           + bytes(18), False),
    "pam-repeated-width": (b"P7\nWIDTH 3\nWIDTH 3\nHEIGHT 2\nDEPTH 3\n"
                           b"MAXVAL 255\nENDHDR\n" + bytes(18), False),
    "pam-p7-space": (b"P7 WIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
                     + bytes(18), False),
    "pam-depth-4-untyped": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 4\nMAXVAL 255\n"
                            b"ENDHDR\n" + bytes(24), False),
}


@pytest.mark.parametrize("case", sorted(PNM))
def test_pnm_and_pam(case):
    body, decodes = PNM[case]
    assert (_held_to_cv2(body) is not None) == decodes


@pytest.mark.parametrize("tupltype", [b"RGB_ALPHA", b"GRAYSCALE_ALPHA"])
def test_pam_with_alpha_is_refused_by_name(tupltype):
    """cv2 converts the first pixels of each row and leaves the rest of its
    buffer uninitialised, so its bytes are not a function of the file."""
    depth = 4 if tupltype == b"RGB_ALPHA" else 2
    body = (b"P7\nWIDTH 5\nHEIGHT 3\nDEPTH %d\nMAXVAL 255\nTUPLTYPE %s\n"
            b"ENDHDR\n" % (depth, tupltype)) + bytes(15 * depth)
    with pytest.raises(ValueError, match=tupltype.decode()):
        imdecode.decode_image_u8(body)


BITS = RNG.integers(0, 2, (7, 13))
GRAY = RNG.integers(0, 256, (7, 13), np.uint8)
SUN = {
    "cv2": (_cv2_file(".ras", IMG), True),
    "1-bit": (write_sunras(13, 7, 1, sunras_rows(BITS, 1)), True),
    "1-bit-map": (write_sunras(13, 7, 1, sunras_rows(BITS, 1),
                               colormap=IMG[0, :2]), True),
    "8-bit-gray-old-type": (write_sunras(13, 7, 8, sunras_rows(GRAY, 8),
                                         kind=0), True),
    "8-bit-short-map": (write_sunras(13, 7, 8, sunras_rows(GRAY, 8),
                                     colormap=IMG.reshape(-1, 3)[:40]), True),
    "24-bit-odd-width": (write_sunras(13, 7, 24, sunras_rows(IMG, 24)), True),
    "32-bit": (write_sunras(13, 7, 32, RNG.integers(
        0, 256, (7, 13, 4), np.uint8).tobytes()), True),
    "depth-4": (write_sunras(13, 7, 4, bytes(70)), False),
    "map-on-24-bit": (write_sunras(13, 7, 24, sunras_rows(IMG, 24),
                                   colormap=IMG[0]), False),
    "short": (write_sunras(13, 7, 24, sunras_rows(IMG, 24))[:200], False),
}


@pytest.mark.parametrize("case", sorted(SUN))
def test_sun_raster(case):
    body, decodes = SUN[case]
    assert (_held_to_cv2(body) is not None) == decodes


@pytest.mark.parametrize("kind,name", [(2, "byte-encoded"), (3, "RGB")])
def test_sun_raster_types_cv2_refuses_are_refused_by_name(kind, name):
    for depth, data in ((8, bytes([0x80, 3, 9]) * 30),
                        (24, sunras_rows(IMG, 24))):
        body = write_sunras(13, 7, depth, data, kind=kind)
        assert cv2.imdecode(np.frombuffer(body, np.uint8), 1) is None
        with pytest.raises(ValueError, match=name):
            imdecode.decode_image_u8(body)


RGBE = RNG.integers(0, 256, (7, 13, 4)).astype(np.uint8)
RGBE[..., 3] = RNG.integers(120, 140, (7, 13))
RGBE[2, 3:11] = RGBE[2, 3]
BRIGHT = RGBE.copy()
BRIGHT[..., 3] = RNG.integers(140, 256, (7, 13))
RUN_OVER = bytearray(write_hdr(RGBE))
RUN_OVER[RUN_OVER.index(b"+X 13\n") + 10] = 128 + 14     # a run past the plane
HDR = {
    "cv2-rle": (_cv2_file(".hdr", IMG.astype(np.float32) / 200), True),
    "rle": (write_hdr(RGBE), True),
    "flat-narrow": (write_hdr(RGBE[:, :5], rle=False), True),
    "flat-wide": (write_hdr(RGBE, rle=False), True),
    "rle-then-flat": (write_hdr(RGBE[:3]).replace(b"-Y 3", b"-Y 7")
                      + RGBE[3:].tobytes(), True),
    "bright-overflows": (write_hdr(BRIGHT, header=b"#?RGBE\nEXPOSURE=1\n# "
                                   + b"x" * 150 + b"\n"), True),
    "extra-bytes": (write_hdr(RGBE) + b"tail", True),
    "no-format": (b"#?RADIANCE\n\n-Y 1 +X 4\n" + bytes(16), False),
    "blank-before-format": (b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n"
                            b"-Y 1 +X 4\n" + bytes(16), False),
    "no-blank": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n-Y 1 +X 4\n"
                 + bytes(16), False),
    "plus-y": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 1 +X 4\n"
               + bytes(16), False),
    "xyze": (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 4\n"
             + bytes(16), False),
    "short": (write_hdr(RGBE)[:-10], False),
    "run-past-scanline": (bytes(RUN_OVER), False),
}


@pytest.mark.parametrize("case", sorted(HDR))
def test_radiance_hdr(case):
    body, decodes = HDR[case]
    assert (_held_to_cv2(body) is not None) == decodes


F = RNG.normal(100, 120, (5, 7, 3)).astype(np.float32)
F[0, :3] = [np.inf, np.nan, 3e9]
F[1, :3] = [254.5, 255.5, 2e9]
PFM = {
    "cv2": (_cv2_file(".pfm", IMG.astype(np.float32) / 3), True),
    "little-endian": (write_pfm(F, -1.0), True),
    "big-endian-scaled": (write_pfm(F, 2.5), True),
    "gray": (write_pfm(F[..., 0], -1.0), True),
    "scale-0": (write_pfm(F, -1.0).replace(b"-1.0\n", b"0\n\n", 1), False),
    "short": (write_pfm(F, -1.0)[:-4], False),
}


@pytest.mark.parametrize("case", sorted(PFM))
def test_pfm(case):
    body, decodes = PFM[case]
    assert (_held_to_cv2(body) is not None) == decodes


def test_hdr_is_scaled_by_255_and_pfm_is_not():
    """The same float image: cv2 gives HDR as ``round(v * 255)`` and PFM as
    ``round(v)``, both saturated; so does the port."""
    rgbe = np.array([[[128, 64, 32, 129], [255, 3, 0, 128]]], np.uint8)
    v = rgbe[..., :3] * 2.0 ** (rgbe[..., 3:].astype(float) - 136)
    got = _held_to_cv2(write_hdr(rgbe, rle=False))
    np.testing.assert_array_equal(got, np.clip(np.rint(v * 255), 0, 255))
    got = _held_to_cv2(write_pfm(v.astype(np.float32) * 255))
    np.testing.assert_array_equal(got, np.clip(np.rint(v * 255), 0, 255))
    got = _held_to_cv2(write_pfm(v.astype(np.float32)))
    np.testing.assert_array_equal(got, np.rint(v).astype(np.uint8))
