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
- the formats only the HTTP tier receives: ``lr<i>_lossy.webp`` (cv2,
  quality 90), ``lr<i>_lossless.webp`` (Pillow) and ``lr<i>.gif`` (Pillow)
  for each LR surface, ``lr0.ppm.xz`` and ``lr0.hdr`` (cv2), ``s512_lossy
  .webp``, ``s512_lossless.webp`` and ``s512.gif``; ``edge_*`` WebP (VP8
  frames under every header tool from ``vp8_frame``, alpha raw and
  compressed, palettes, animations, metadata chunks), GIF (interlace,
  local and missing tables, transparency on an offset frame, animation,
  GIF87a, a full LZW table), PBM/PGM/PPM/PAM, Sun raster, HDR and PFM;
- ``manifest.json``: per file, its bytes' sha256 (of the file as stored,
  packed or not) and the shape and sha256 of ``cv2.imdecode(IMREAD_COLOR)``
  swapped to RGB, of the unpacked bytes; for WebP also what the bitstream
  uses (``tools``: VP8 modes, filter, partitions and segments, VP8L
  transforms and cache, alpha, animation), as the port's decoder reads it.

    python tests/data/formats/make_fixtures.py

Needs OpenCV and Pillow; the writers are ``tests/torch_image_writers.py``'s.
"""

import lzma
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from torch_image_writers import (bmp_rows, random_components, rgbq,  # noqa: E402
                                 riff_chunk, sunras_rows, vp8_frame,
                                 webp_file, write_bmp, write_gif, write_hdr,
                                 write_jpeg, write_pfm, write_png,
                                 write_sunras, write_tiff)


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
    out.update(served_formats(imencode))
    return out


def _pil(img, fmt, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def _webp_chunks(body: bytes) -> list[tuple[bytes, bytes]]:
    """The chunks of a WebP file after its RIFF header."""
    out, pos = [], 12
    while pos + 8 <= len(body):
        tag = body[pos:pos + 4]
        n = struct.unpack("<I", body[pos + 4:pos + 8])[0]
        out.append((tag, body[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def alpha_stream(alpha: np.ndarray) -> bytes:
    """An alpha plane as the headerless VP8L stream of an ``ALPH`` chunk:
    Pillow's lossless WebP of it in the green channel, less the VP8L
    chunk's 5-byte header."""
    g = np.zeros((*alpha.shape, 3), np.uint8)
    g[..., 1] = alpha
    return dict(_webp_chunks(_pil(g, "WEBP", lossless=True)))[b"VP8L"][5:]


def _anmf(x, y, w, h, chunks) -> bytes:
    return ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
            + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
            + (100).to_bytes(3, "little") + b"\0"
            + b"".join(riff_chunk(t, d) for t, d in chunks if t != b"VP8X"))


def served_formats(imencode) -> dict[str, bytes]:
    """The fixtures of the formats only the HTTP tier receives."""
    import cv2
    rng = np.random.default_rng(20)
    out = {}
    rgb = scene(rng, 512, 512, noise=0.0) // 4 * 4
    out["s512_lossy.webp"] = imencode(".webp", rgb[..., ::-1],
                                      cv2.IMWRITE_WEBP_QUALITY, 90)
    out["s512_lossless.webp"] = _pil(rgb, "WEBP", lossless=True)
    out["s512.gif"] = _pil(rgb, "GIF")
    for i in range(4):
        lr = scene(np.random.default_rng(18 + i), 128, 128, noise=2.0)
        out[f"lr{i}_lossy.webp"] = imencode(".webp", lr[..., ::-1],
                                            cv2.IMWRITE_WEBP_QUALITY, 90)
        out[f"lr{i}_lossless.webp"] = _pil(lr, "WEBP", lossless=True)
        out[f"lr{i}.gif"] = _pil(lr, "GIF")
        if i == 0:
            out["lr0.ppm.xz"] = imencode(".ppm", lr[..., ::-1])
            out["lr0.hdr"] = imencode(".hdr", lr[..., ::-1].astype(np.float32)
                                      / 255)
    # ---- WebP
    small = scene(rng, 37, 37)[:29]
    for name, kw in (
            ("simple", dict(filter_type="simple", level=30, sharpness=3,
                            partitions=4, skip_prob=80, prob_updates=0.05,
                            lf_delta=([5, 0, 0, 0], [-9, 0, 0, 0]))),
            ("segments", dict(level=25, sharpness=6, partitions=8,
                              q_deltas=(3, -4, 5, 8, -2),
                              segments=dict(quant=[5, -10, 20, 0],
                                            lf=[3, -5, 10, 0],
                                            map_probs=[100, 150, 200]))),
            ("absolute", dict(level=40, partitions=2, lf_delta=(
                [-3, 0, 0, 0], [12, 0, 0, 0]), segments=dict(
                quant=[50, 10, 90, 3], lf=[30, 5, 63, 0], absolute=True,
                map_probs=[10, 250, 128]))),
            ("q0", dict(q_index=0, level=63, big=0.3)),
            ("nofilter", dict(level=0, i16_share=0.8))):
        out[f"edge_vp8_{name}.webp"] = webp_file(
            [(b"VP8 ", vp8_frame(rng, 37, 29, **kw))])
    out["edge_lossy_1x1.webp"] = imencode(".webp", small[:1, :1],
                                          cv2.IMWRITE_WEBP_QUALITY, 80)
    out["edge_lossy_odd.webp"] = imencode(".webp", small,
                                          cv2.IMWRITE_WEBP_QUALITY, 50)
    rgba = np.dstack([small, rng.integers(0, 256, (29, 37), np.uint8)])
    out["edge_alpha_lossy.webp"] = _pil(rgba, "WEBP", quality=70)
    out["edge_alpha_lossless.webp"] = _pil(rgba, "WEBP", lossless=True,
                                           exact=True)
    frame = vp8_frame(rng, 37, 29)
    out["edge_alpha_raw.webp"] = webp_file(
        [(b"ALPH", bytes([3 << 2]) + rng.integers(0, 256, 37 * 29, np.uint8)
          .tobytes()), (b"VP8 ", frame)], vp8x=(0x10, 37, 29))
    for name, filt in (("alpha_vp8l", 1), ("alpha_vp8l_vertical", 2)):
        out[f"edge_{name}.webp"] = webp_file(
            [(b"ALPH", bytes([1 | filt << 2]) + alpha_stream(rgba[..., 3])),
             (b"VP8 ", vp8_frame(rng, 37, 29))], vp8x=(0x10, 37, 29))
    out["edge_lossless_m0.webp"] = _pil(small, "WEBP", lossless=True,
                                        method=0)
    pal = rng.integers(0, 256, (12, 3)).astype(np.uint8)
    out["edge_palette.webp"] = _pil(pal[rng.integers(0, 12, (29, 37))],
                                    "WEBP", lossless=True)
    out["edge_palette2.webp"] = _pil(pal[rng.integers(0, 2, (29, 37))],
                                     "WEBP", lossless=True)
    first = rgba[:20, :24]
    for name, lossless in (("anim", False), ("anim_lossless", True)):
        frames = [_anmf(6, 4, 24, 20, _webp_chunks(_pil(
                      first, "WEBP", lossless=lossless, exact=True))),
                  _anmf(0, 0, 37, 29, _webp_chunks(_pil(
                      small, "WEBP", lossless=lossless)))]
        out[f"edge_{name}.webp"] = webp_file(
            [(b"ANIM", bytes(4) + b"\0\0")]
            + [(b"ANMF", f) for f in frames], vp8x=(0x12, 37, 29))
    out["edge_vp8x_meta.webp"] = _pil(small, "WEBP", quality=60,
                                      exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0",
                                      xmp=b"<x:xmpmeta/>")
    # ---- GIF
    gpal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    idx = rng.integers(0, 256, (29, 37))
    out["edge_interlace.gif"] = write_gif([dict(idx=idx, interlace=True)],
                                          37, 29, gpal)
    lidx = rng.integers(0, 16, (21, 19))
    out["edge_local.gif"] = write_gif(
        [dict(idx=lidx, palette=gpal[100:104], min_size=4, x=5, y=3)],
        37, 29, gpal, background=7)
    out["edge_transparent.gif"] = write_gif(
        [dict(idx=lidx, transparent=3, min_size=4, x=9, y=2)], 37, 29,
        gpal[:16], background=5)
    out["edge_anim.gif"] = write_gif(
        [dict(idx=idx[:20, :30], x=2, y=4), dict(idx=idx, disposal=2)],
        37, 29, gpal, background=9, loop=True)
    out["edge_nopal.gif"] = write_gif([dict(idx=idx)], 37, 29, None)
    out["edge_87a.gif"] = write_gif([dict(idx=lidx, min_size=4)], 19, 21,
                                    gpal[:16], version=b"87a")
    out["edge_full_table.gif"] = write_gif(
        [dict(idx=rng.integers(0, 256, (64, 64)))], 64, 64, gpal)
    # ---- PBM, PGM, PPM, PAM
    bits = rng.integers(0, 2, (7, 13))
    out["edge_p1.pbm"] = b"P1\n# a comment\n13 7\n" + b"\n".join(
        b" ".join(b"%d" % v for v in row) for row in bits) + b"\n"
    out["edge_p4.pbm"] = b"P4 13 7\n" + np.packbits(bits, axis=1).tobytes()
    g = rng.integers(0, 1100, (7, 13))
    out["edge_p2_16.pgm"] = b"P2\n13 7 # size\n1000\n" + b"\n".join(
        b" ".join(b"%d" % v for v in row) for row in g) + b"\n"
    out["edge_p5.pgm"] = b"P5\n13\t7\n100\n" + rng.integers(
        0, 256, (7, 13), np.uint8).tobytes()
    out["edge_p5_16.pgm"] = b"P5 13 7 65535\n" + rng.integers(
        0, 65536, (7, 13)).astype(">u2").tobytes()
    c = rng.integers(0, 20, (7, 13, 3))
    out["edge_p3.ppm"] = b"P3 13 7 15\n" + b" ".join(
        b"%d" % v for v in c.ravel()) + b"\n"
    out["edge_p6_16.ppm"] = b"P6\n13 7\n4095\n" + rng.integers(
        0, 4096, (7, 13, 3)).astype(">u2").tobytes()
    pam = b"P7\nWIDTH 13\nHEIGHT 7\nDEPTH %d\nMAXVAL %d\n%sENDHDR\n"
    out["edge_rgb.pam"] = pam % (3, 255, b"TUPLTYPE RGB\n") + rng.integers(
        0, 256, (7, 13, 3), np.uint8).tobytes()
    out["edge_gray16.pam"] = pam % (1, 1000, b"# gray\nTUPLTYPE GRAYSCALE\n") \
        + rng.integers(0, 65536, (7, 13)).astype(">u2").tobytes()
    out["edge_bw.pam"] = pam % (1, 1, b"TUPLTYPE BLACKANDWHITE\n") \
        + rng.integers(0, 256, (7, 13), np.uint8).tobytes()
    # ---- Sun raster
    gray = rng.integers(0, 256, (7, 13), np.uint8)
    out["edge_1bit.ras"] = write_sunras(13, 7, 1, sunras_rows(bits, 1))
    out["edge_1bit_map.ras"] = write_sunras(13, 7, 1, sunras_rows(bits, 1),
                                            colormap=gpal[:2])
    out["edge_8bit_gray.ras"] = write_sunras(13, 7, 8, sunras_rows(gray, 8),
                                             kind=0)
    out["edge_8bit_map.ras"] = write_sunras(13, 7, 8, sunras_rows(gray, 8),
                                            colormap=gpal[:200])
    out["edge_24bit.ras"] = write_sunras(13, 7, 24, sunras_rows(
        rng.integers(0, 256, (7, 13, 3)), 24))
    out["edge_32bit.ras"] = write_sunras(13, 7, 32, rng.integers(
        0, 256, (7, 13, 4), np.uint8).tobytes())
    # ---- Radiance HDR and PFM
    rgbe = rng.integers(0, 256, (7, 13, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (7, 13))
    rgbe[2, 3:11] = rgbe[2, 3]                      # runs
    out["edge_rle.hdr"] = write_hdr(rgbe)
    out["edge_flat.hdr"] = write_hdr(rgbe[:, :5], rle=False)
    out["edge_rle_then_flat.hdr"] = write_hdr(rgbe[:3]) + \
        rgbe[3:].tobytes()
    out["edge_rle_then_flat.hdr"] = out["edge_rle_then_flat.hdr"].replace(
        b"-Y 3 +X 13", b"-Y 7 +X 13", 1)
    bright = rgbe.copy()
    bright[..., 3] = rng.integers(140, 256, (7, 13))
    out["edge_bright.hdr"] = write_hdr(bright, header=b"#?RGBE\nEXPOSURE=1"
                                       b"\n# " + b"x" * 150 + b"\n")
    f = rng.normal(100, 120, (7, 13, 3)).astype(np.float32)
    f[0, :3] = [np.inf, np.nan, 3e9]
    out["edge_le.pfm"] = write_pfm(f, -1.0)
    out["edge_be.pfm"] = write_pfm(f, 2.5)
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
        if ".webp" in name:
            from tpusr_torch.pipeline.webp import decode_webp
            tools = {}
            decode_webp(body, tools=tools)
            manifest[name]["tools"] = tools
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"wrote {len(manifest)} fixtures to {HERE}")


if __name__ == "__main__":
    main()
