"""Image files to RGB arrays, dispatched on their magic bytes.

The JAX package reads dataset files with ``cv2.imread`` and request bodies
with ``cv2.imdecode`` (``tpusr/data/loading.py:54-57``,
``tpusr/pipeline/http_serving.py:29-37``). The port has no image library,
so it carries a decoder for each format the JAX loaders list and for each
further format the HTTP tier could receive, each written to give what
``cv2.imdecode(buf, IMREAD_COLOR)`` and the BGR->RGB swap give, byte for
byte (cv2 5.0.0):

- PNG (``pipeline/png.py``): every colour type and bit depth, Adam7;
- JPEG (``pipeline/jpeg.py``): baseline, extended sequential and
  progressive Huffman JPEG at 8 bits, gray, YCbCr, RGB, CMYK and YCCK;
- BMP (``pipeline/bmp.py``): OpenCV's own ``BmpDecoder``;
- TIFF (``pipeline/tiff.py``): classic TIFF and BigTIFF, uncompressed,
  LZW, Deflate and PackBits;
- WebP (``pipeline/webp.py`` with ``vp8.py`` and ``vp8l.py``): lossy,
  lossless, with alpha (dropped), and an animation's first frame;
- GIF (``pipeline/gif.py``): OpenCV's own decoder, the first frame;
- PNM (``pipeline/pnm.py``): P1-P6 ASCII and binary, 8 and 16 bits, and
  PAM (P7) gray, black-and-white and RGB;
- Sun raster (``pipeline/sunras.py``): depths 1, 8, 24 and 32;
- Radiance HDR and PFM (``pipeline/hdr.py``).

JPEG 2000, AVIF and OpenEXR (which this cv2 cannot read either) raise
``ValueError`` naming them, as does what a decoder refuses. The decoders
are held against cv2 on the CPU by ``tests/test_torch_{png_formats,bmp,
tiff,jpeg,jpeg_formats,webp,gif,pnm_hdr,formats_fixtures}.py``
(``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_webp.py ...``).
"""

from __future__ import annotations

import numpy as np

from tpusr_torch.pipeline.bmp import decode_bmp_u8
from tpusr_torch.pipeline.gif import decode_gif_u8
from tpusr_torch.pipeline.hdr import decode_hdr_u8, decode_pfm_u8
from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
from tpusr_torch.pipeline.png import SIGNATURE as PNG_SIGNATURE
from tpusr_torch.pipeline.png import decode_png_u8
from tpusr_torch.pipeline.pnm import decode_pnm_u8
from tpusr_torch.pipeline.sunras import decode_sunras_u8
from tpusr_torch.pipeline.tiff import decode_tiff_u8
from tpusr_torch.pipeline.webp import decode_webp_u8

_MAGIC = ((PNG_SIGNATURE, "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"),
          (b"MM\x00+", "TIFF"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
          (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
          (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"#?RADIANCE", "HDR"),
          (b"#?RGBE", "HDR"), (b"\x59\xa6\x6a\x95", "Sun raster"),
          (b"v/1\x01", "OpenEXR"), (b"PF\n", "PFM"), (b"Pf\n", "PFM"))
_DECODERS = {"PNG": decode_png_u8, "JPEG": decode_jpeg_u8,
             "BMP": decode_bmp_u8, "TIFF": decode_tiff_u8,
             "WebP": decode_webp_u8, "GIF": decode_gif_u8,
             "PNM": decode_pnm_u8, "Sun raster": decode_sunras_u8,
             "HDR": decode_hdr_u8, "PFM": decode_pfm_u8}
DECODED = ", ".join(_DECODERS)


def image_format(body: bytes) -> str | None:
    """The name of the image format ``body`` starts with, or None."""
    if body[:4] == b"RIFF" and body[8:12] == b"WEBP":
        return "WebP"
    if body[4:8] == b"ftyp" and body[8:12] in (b"avif", b"avis"):
        return "AVIF"
    if len(body) > 2 and body[:1] == b"P" and body[1:2] in b"1234567" \
            and body[2:3].isspace():
        return "PNM"
    return next((name for magic, name in _MAGIC if body.startswith(magic)),
                None)


def decode_image_u8(body: bytes,
                    expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Image bytes -> (h, w, 3) uint8 RGB, what ``cv2.imdecode(
    IMREAD_COLOR)`` and the BGR->RGB swap give; another format raises
    ``ValueError`` naming it. ``expected_hw`` refuses an image whose header
    declares another size before its data is decoded (an orientation tag
    may still transpose it: check the result's shape too)."""
    fmt = image_format(body)
    if fmt in _DECODERS:
        return _DECODERS[fmt](body, expected_hw)
    raise ValueError(
        f"request body is a {fmt} image; the port decodes {DECODED} only"
        if fmt else f"request body is not a decodable image (one of "
                    f"{DECODED} expected)")


def decode_image(body: bytes,
                 expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Image bytes -> (h, w, 3) float32 RGB in [0, 1]."""
    return decode_image_u8(body, expected_hw).astype(np.float32) / 255.0
