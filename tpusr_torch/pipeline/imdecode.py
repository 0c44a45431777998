"""Image files to RGB arrays, dispatched on their magic bytes.

The JAX package reads dataset files with ``cv2.imread`` and request bodies
with ``cv2.imdecode`` (``tpusr/data/loading.py:54-57``,
``tpusr/pipeline/http_serving.py:29-37``). The port has no image library,
so it carries a decoder for each format the JAX loaders list, each written
to give what ``cv2.imdecode(buf, IMREAD_COLOR)`` and the BGR->RGB swap give,
byte for byte:

- PNG (``pipeline/png.py``): every colour type and bit depth, Adam7;
- JPEG (``pipeline/jpeg.py``): baseline, extended sequential and
  progressive Huffman JPEG at 8 bits, gray, YCbCr, RGB, CMYK and YCCK;
- BMP (``pipeline/bmp.py``): OpenCV's own ``BmpDecoder``;
- TIFF (``pipeline/tiff.py``): classic TIFF and BigTIFF, uncompressed,
  LZW, Deflate and PackBits.

Any other format (GIF, WebP, AVIF, JPEG 2000, PNM, ...) raises
``ValueError`` naming it, as does what a decoder refuses.
"""

from __future__ import annotations

import numpy as np

from tpusr_torch.pipeline.bmp import decode_bmp_u8
from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
from tpusr_torch.pipeline.png import SIGNATURE as PNG_SIGNATURE
from tpusr_torch.pipeline.png import decode_png_u8
from tpusr_torch.pipeline.tiff import decode_tiff_u8

_MAGIC = ((PNG_SIGNATURE, "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"),
          (b"MM\x00+", "TIFF"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
          (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
          (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"#?RADIANCE", "HDR"),
          (b"#?RGBE", "HDR"), (b"\x59\xa6\x6a\x95", "Sun raster"),
          (b"v/1\x01", "OpenEXR"), (b"PF\n", "PFM"), (b"Pf\n", "PFM"))
_DECODERS = {"PNG": decode_png_u8, "JPEG": decode_jpeg_u8,
             "BMP": decode_bmp_u8, "TIFF": decode_tiff_u8}


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
        f"request body is a {fmt} image; the port decodes PNG, JPEG, BMP "
        f"and TIFF only" if fmt else
        "request body is not a decodable image (PNG, JPEG, BMP or TIFF "
        "expected)")


def decode_image(body: bytes,
                 expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Image bytes -> (h, w, 3) float32 RGB in [0, 1]."""
    return decode_image_u8(body, expected_hw).astype(np.float32) / 255.0
