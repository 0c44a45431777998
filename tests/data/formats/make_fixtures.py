"""Write the image-format fixtures beside this file, with OpenCV's decode of
each, for checks on a machine that has no OpenCV (``chip_smoke.py``'s
``phase_formats`` and ``phase_serve``) and for
``tests/test_torch_formats_fixtures.py``:

- ``s512_*``: one 512^2 scene in each format the port decodes: baseline
  and progressive JPEG (cv2, quality 90, 4:2:0), PNG (cv2) and Adam7 PNG,
  BMP (cv2, 24 bpp, xz-packed: ``.bmp.xz``), TIFF uncompressed (xz-packed),
  LZW and Deflate (predictor 2, 16 rows a strip); a smooth scene with
  sharp-edged blobs, no noise and levels in steps of 4, to keep the files
  small;
- ``lr<i>_*``: four 128^2 LR surfaces in each format the port now reads
  beside PNG: progressive JPEG, Adam7 PNG, BMP (xz-packed) and TIFF (LZW,
  predictor 2);
- ``edge_*``: small files for what only a hand-made file holds (Adam7 at
  low depths, RLE BMPs with deltas, 5-6-5 and OS/2 BMPs, tiled, planar,
  BigTIFF, predictor-2 16-bit, palette and bilevel TIFFs, extended
  sequential, 4:1:1, RGB, CMYK and YCCK JPEGs);
- ``manifest.json``: per file, its bytes' sha256 (of the file as stored,
  packed or not) and the shape and sha256 of ``cv2.imdecode(IMREAD_COLOR)``
  swapped to RGB, of the unpacked bytes.

    python tests/data/formats/make_fixtures.py

Needs OpenCV and Pillow; the writers are ``tests/torch_image_writers.py``'s.
"""

import lzma
import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from torch_image_writers import (bmp_rows, random_components, rgbq,  # noqa: E402
                                 write_bmp, write_jpeg, write_png, write_tiff)


def scene(rng, h, w, noise=3.0):
    """A smooth field with a few sharp-edged blobs and a little noise."""
    import cv2
    x = rng.normal(size=(h // 16 + 2, w // 16 + 2, 3)).cumsum(0).cumsum(1)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    x = (x - x.min()) / (np.ptp(x) + 1e-9) * 200 + 20
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(6):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(4, h // 6)
        x[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] += rng.normal(scale=40, size=3)
    x = x + rng.normal(scale=noise, size=x.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def fixtures() -> dict[str, bytes]:
    import cv2
    from PIL import Image

    def imencode(ext, bgr, *params):
        ok, buf = cv2.imencode(ext, bgr, list(params))
        assert ok
        return buf.tobytes()

    rng = np.random.default_rng(18)
    out = {}
    rgb = scene(rng, 512, 512, noise=0.0) // 4 * 4
    bgr = rgb[..., ::-1]
    out["s512_baseline.jpg"] = imencode(".jpg", bgr, cv2.IMWRITE_JPEG_QUALITY, 90)
    out["s512_progressive.jpg"] = imencode(
        ".jpg", bgr, cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    out["s512.png"] = imencode(".png", bgr)
    out["s512_adam7.png"] = write_png(rgb, 8, 2, interlace=1, sub_every=1)
    out["s512.bmp.xz"] = imencode(".bmp", bgr)
    out["s512_none.tif.xz"] = write_tiff(rgb, rows_per_strip=16)
    out["s512_lzw.tif"] = write_tiff(rgb, compression=5, predictor=2,
                                     rows_per_strip=16)
    out["s512_deflate.tif"] = write_tiff(rgb, compression=8, predictor=2,
                                         rows_per_strip=16)
    for i in range(4):
        lr = scene(rng, 128, 128, noise=2.0)
        out[f"lr{i}_progressive.jpg"] = imencode(
            ".jpg", lr[..., ::-1], cv2.IMWRITE_JPEG_QUALITY, 95,
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        out[f"lr{i}_adam7.png"] = write_png(lr, 8, 2, interlace=1,
                                            sub_every=1)
        out[f"lr{i}.bmp.xz"] = imencode(".bmp", lr[..., ::-1])
        out[f"lr{i}.tif"] = write_tiff(lr, compression=5, predictor=2,
                                       rows_per_strip=32)
    # ---- edge cases
    small = scene(rng, 37, 29)
    for depth in (1, 2, 4, 16):
        hi = 1 << depth
        g = rng.integers(0, hi, (37, 29, 1))
        out[f"edge_adam7_gray{depth}.png"] = write_png(
            g.astype(np.uint16 if depth == 16 else np.uint8), depth, 0,
            interlace=1)
    for depth in (1, 2, 4):
        pal = rng.integers(0, 256, (1 << depth, 3))
        idx = rng.integers(0, 1 << depth, (37, 29, 1)).astype(np.uint8)
        out[f"edge_adam7_palette{depth}.png"] = write_png(
            idx, depth, 3, interlace=1, palette=pal)
    rgba16 = rng.integers(0, 65536, (37, 29, 4)).astype(np.uint16)
    out["edge_adam7_rgba16.png"] = write_png(rgba16, 16, 6, interlace=1)
    exif = (b"II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00\x00\x00"
            b"\x06\x00\x00\x00\x00\x00\x00\x00")
    out["edge_exif6.png"] = write_png(small, 8, 2, chunks=[(b"eXIf", exif)])
    pal = rng.integers(0, 256, (256, 3))
    ops8 = bytes([3, 1, 2, 2, 0, 2, 3, 1, 5, 7, 0, 0, 0, 3, 4, 5, 6, 0, 4, 9,
                  0, 0, 0, 2, 1, 2, 6, 11, 0, 1])
    out["edge_rle8_delta.bmp"] = write_bmp(13, 6, 8, ops8, 1, rgbq(pal))
    # OpenCV ends RLE4 data only at the last row's end: an end of bitmap
    # moves one row down there, a delta only across
    ops4 = bytes([3, 0x12, 0, 2, 2, 0, 4, 0x34, 0, 0, 0, 5, 0x12, 0x34, 0x50,
                  0, 0, 2, 3, 1, 4, 0x56, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0])
    out["edge_rle4_delta.bmp"] = write_bmp(13, 6, 4, ops4, 2, rgbq(pal[:16]))
    t16 = rng.integers(0, 65536, (9, 11)).astype("<u2")
    out["edge_565.bmp"] = write_bmp(11, 9, 16, bmp_rows(t16.view(np.uint8)
                                                        .reshape(9, 22), 8),
                                    3, masks=(0xF800, 0x7E0, 0x1F))
    out["edge_os2_4bpp.bmp"] = write_bmp(
        11, 9, 4, bmp_rows(rng.integers(0, 16, (9, 11)), 4),
        palette=pal[:16, ::-1].astype(np.uint8).tobytes(), header=12)
    out["edge_topdown_32bpp.bmp"] = write_bmp(
        11, -9, 32, rng.integers(0, 256, (9, 11, 4)).astype(np.uint8).tobytes())
    out["edge_1bpp_v5.bmp"] = write_bmp(
        13, 7, 1, bmp_rows(rng.integers(0, 2, (7, 13)), 1),
        palette=rgbq(pal[:2]), header=124)
    out["edge_tiled_lzw.tif"] = write_tiff(small, compression=5, tile=(16, 16))
    out["edge_planar_deflate.tif"] = write_tiff(small, compression=8, planar=2,
                                                rows_per_strip=8)
    out["edge_pred16_lzw_mm.tif"] = write_tiff(
        rng.integers(0, 65536, (37, 29, 3)).astype(np.uint16), compression=5,
        predictor=2, order=">", rows_per_strip=10)
    out["edge_bigtiff.tif"] = write_tiff(small, big=True, compression=32773)
    out["edge_palette4.tif"] = write_tiff(
        rng.integers(0, 16, (37, 29)).astype(np.uint8), photometric=3,
        colormap=rng.integers(0, 65536, (16, 3)), bits=4, compression=5)
    out["edge_bilevel_white.tif"] = write_tiff(
        rng.integers(0, 2, (37, 29)).astype(np.uint8), photometric=0, bits=1,
        compression=32773, rows_per_strip=9)
    out["edge_rgba_orient6.tif"] = write_tiff(
        rng.integers(0, 256, (37, 29, 4)).astype(np.uint8), extra=[2],
        orientation=6, compression=8)
    comps = random_components(rng, 37, 29, ((4, 1), (1, 1), (1, 1)))
    out["edge_411.jpg"] = write_jpeg(comps, 37, 29)
    comps = random_components(rng, 37, 29, ((2, 2), (1, 1), (1, 1)))
    out["edge_sof1_rst.jpg"] = write_jpeg(comps, 37, 29, restart=2, sof=0xC1)
    comps = random_components(rng, 37, 29, ((1, 1), (1, 1), (1, 1)))
    out["edge_rgb_adobe.jpg"] = write_jpeg(comps, 37, 29, adobe=0, jfif=False)
    comps = random_components(rng, 37, 29, ((2, 2), (1, 1), (1, 1), (2, 2)))
    out["edge_ycck.jpg"] = write_jpeg(comps, 37, 29, adobe=2, jfif=False)
    buf = io.BytesIO()
    Image.fromarray(small).convert("CMYK").save(buf, "JPEG", quality=85)
    out["edge_cmyk.jpg"] = buf.getvalue()
    out["edge_progressive_gray_rst.jpg"] = imencode(
        ".jpg", small[..., 0], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    return out


def unpacked(name: str, stored: bytes) -> bytes:
    """A fixture's bytes as the decoder reads them (``.xz`` ones unpacked)."""
    return lzma.decompress(stored) if name.endswith(".xz") else stored


def main():
    import cv2
    manifest = {}
    for name, body in fixtures().items():
        stored = lzma.compress(body, preset=9 | lzma.PRESET_EXTREME) \
            if name.endswith(".xz") else body
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(stored)
        bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        assert bgr is not None, name
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        manifest[name] = {
            "file_sha256": hashlib.sha256(stored).hexdigest(),
            "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"wrote {len(manifest)} fixtures to {HERE}")


if __name__ == "__main__":
    main()
