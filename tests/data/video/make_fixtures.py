"""Write the video, JPEG-encoder and resize fixtures beside this file, with
OpenCV's answers, for checks on a machine that has no OpenCV
(``chip_smoke.py``'s preprocess phase) and for ``tests/test_torch_video.py``,
``tests/test_torch_jpeg_encode.py`` and ``tests/test_torch_eda.py``:

- ``clip_80x60.avi``: the JAX video tests' clip (MJPG, 10 fps, 30 frames),
  written by ``cv2.VideoWriter``; ``print_720p.avi``: 1280x720, 10 fps, 40
  frames of a printed part moving over the bed, written by
  ``cv2.VideoWriter``; ``odd_59x80.avi``: 59 wide, 80 high, 20 frames of
  ``cv2.imencode`` JPEGs in an AVI written here (``write_avi``), an odd
  crop for the preprocess command's trim;
- ``manifest.json``: per clip, ``cv2.VideoCapture``'s rate, frame count
  and the sha256 of each frame's BGR bytes, with two frames of each clip as
  ``<clip>_f<i>.png``; per encoder input ``enc_<h>x<w>.png``, the sha256 of
  ``cv2.imencode(".jpeg", bgr, [IMWRITE_JPEG_QUALITY, q])`` at each
  quality, whose bytes are ``enc_<h>x<w>_q<q>.jpg``; per resize case, the
  sha256 of the input ``pattern`` and of ``cv2.resize``'s output (the x3
  cubic outputs also as ``resize_*.png``, with the port's count of values
  that differ, ``port_mismatch``).

    python tests/data/video/make_fixtures.py

Needs OpenCV (and the port, for ``port_mismatch``).
"""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
QUALITIES = (1, 20, 37, 59, 75, 100)
ENCODE_SIZES = ((1, 1), (8, 8), (17, 23), (24, 24), (256, 256))
CUBIC_CASES = [((h, w), f) for f in (2, 2.5, 3, 4)
               for (h, w) in ((12, 12), (16, 9), (32, 32))]
AREA_CASES = [(64, 32), (96, 48), (60, 48), (607, 512), (720, 512),
              (1080, 512)]


def pattern(h: int, w: int, kind: str) -> np.ndarray:
    """A deterministic (h, w, 3) uint8 image from integer arithmetic only
    (the same bits on any machine): ``noise`` hashes the coordinates,
    ``smooth`` is a slanted triangle wave."""
    y = np.arange(h, dtype=np.uint64)[:, None, None]
    x = np.arange(w, dtype=np.uint64)[None, :, None]
    c = np.arange(3, dtype=np.uint64)[None, None, :]
    if kind == "noise":
        v = (x * np.uint64(2654435761) + y * np.uint64(40503)
             + c * np.uint64(97)) & np.uint64(0xFFFFFFFF)
        v ^= v >> np.uint64(13)
        v = (v * np.uint64(1274126177)) & np.uint64(0xFFFFFFFF)
        v ^= v >> np.uint64(16)
        return (v & np.uint64(255)).astype(np.uint8)
    t = (x * np.uint64(5) + y * np.uint64(3) + c * np.uint64(70)) % np.uint64(510)
    return np.abs(t.astype(np.int64) - 255).astype(np.uint8)


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()
                          if isinstance(a, np.ndarray) else a).hexdigest()


def write_avi(path: str, jpegs: list, width: int, height: int,
              rate: int = 10, scale: int = 1, fourcc: bytes = b"MJPG") -> None:
    """A minimal AVI 1.0 of one video stream whose ``00dc`` chunks are
    ``jpegs`` (no index)."""
    def chunk(cid, data):
        return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def lst(kind, data):
        return b"LIST" + struct.pack("<I", len(data) + 4) + kind + data

    n = len(jpegs)
    avih = struct.pack("<14I", 1000000 * scale // rate, 0, 0, 0x10, n, 0, 1,
                       0, width, height, 0, 0, 0, 0)
    strh = (b"vids" + fourcc + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, scale,
                                           rate, 0, n, 0, 0xFFFFFFFF, 0)
            + struct.pack("<4h", 0, 0, width, height))
    strf = (struct.pack("<IiiHH", 40, width, height, 1, 24) + fourcc
            + struct.pack("<IiiII", width * height * 3, 0, 0, 0, 0))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", j) for j in jpegs))
    body = b"AVI " + hdrl + movi
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def small_clip(path: str) -> None:
    """tests/test_video.py's clip."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (80, 60))
    rng = np.random.default_rng(0)
    for i in range(30):
        frame = np.full((60, 80, 3), 30, np.uint8)
        frame[10:50, 20 + i // 3: 60 + i // 3] = (
            rng.integers(100, 255, 3).astype(np.uint8))
        w.write(frame)
    w.release()


def print_frame(i: int, w: int = 1280, h: int = 720) -> np.ndarray:
    """A printed part (layer lines) moving over a shaded bed, with sensor
    noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bed = 40 + 20 * np.sin(xx / 210.0) + 15 * np.cos(yy / 170.0)
    img = np.stack([bed, bed * 1.05, bed * 0.95], -1)
    cx, cy = 560 + 6 * i, 330 + 2 * i
    part = ((xx - cx) / 260.0) ** 2 + ((yy - cy) / 190.0) ** 2 < 1.0
    layers = 150 + 40 * np.sin(yy / 2.5) + 25 * np.sin(xx / 37.0 + i / 5.0)
    img[part] = layers[part, None] * np.array([0.35, 0.75, 1.0], np.float32)
    img += np.random.default_rng(i).normal(0, 2.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def print_clip(path: str, frames: int = 40) -> None:
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        (1280, 720))
    for i in range(frames):
        w.write(print_frame(i))
    w.release()


def odd_clip(path: str, frames: int = 20) -> None:
    w, h = 59, 80
    jpegs = []
    for i in range(frames):
        img = np.full((h, w, 3), 25, np.uint8)
        img[20 + i: 50 + i, 10:40] = (60, 180, 230)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        jpegs.append(enc.tobytes())
    write_avi(path, jpegs, w, h)


def clip_entry(name: str, keep: tuple) -> dict:
    cap = cv2.VideoCapture(os.path.join(HERE, name))
    fps = cap.get(cv2.CAP_PROP_FPS)
    hashes, shape = [], None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if len(hashes) in keep:
            cv2.imwrite(os.path.join(HERE, f"{name[:-4]}_f{len(hashes)}.png"),
                        frame)
        hashes.append(sha(frame))
        shape = frame.shape
    cap.release()
    return {"fps": fps, "frames": len(hashes), "height": shape[0],
            "width": shape[1], "sha256": hashes, "png_frames": list(keep)}


def main() -> None:
    sys.path.insert(0, REPO)
    import torch
    from tpusr_torch.data._cv_ops import resize_u8

    small_clip(os.path.join(HERE, "clip_80x60.avi"))
    print_clip(os.path.join(HERE, "print_720p.avi"))
    odd_clip(os.path.join(HERE, "odd_59x80.avi"))
    manifest = {"clips": {
        "clip_80x60.avi": clip_entry("clip_80x60.avi", (0, 15)),
        "print_720p.avi": clip_entry("print_720p.avi", (0, 20)),
        "odd_59x80.avi": clip_entry("odd_59x80.avi", (0, 10))}}

    enc = {}
    for h, w in ENCODE_SIZES:
        img = pattern(h, w, "smooth") // 2 + pattern(h, w, "noise") // 4
        cv2.imwrite(os.path.join(HERE, f"enc_{h}x{w}.png"), img[..., ::-1])
        entry = {"input_sha256": sha(img), "jpeg_sha256": {}}
        for q in QUALITIES:
            ok, out = cv2.imencode(".jpeg", img[..., ::-1].copy(),
                                   [cv2.IMWRITE_JPEG_QUALITY, q])
            with open(os.path.join(HERE, f"enc_{h}x{w}_q{q}.jpg"), "wb") as f:
                f.write(out.tobytes())
            entry["jpeg_sha256"][str(q)] = sha(out.tobytes())
        enc[f"{h}x{w}"] = entry
    manifest["encode"] = enc

    cases = []
    for (h, w), f in CUBIC_CASES:
        oh, ow = int(h * f), int(w * f)
        img = pattern(h, w, "noise")
        out = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
        case = {"method": "bicubic", "in": [h, w], "out": [oh, ow],
                "kind": "noise", "input_sha256": sha(img),
                "sha256": sha(out)}
        port = resize_u8(torch.from_numpy(img), (oh, ow), "bicubic").numpy()
        case["port_mismatch"] = int((port != out).sum())
        if case["port_mismatch"]:
            case["png"] = f"resize_cubic_{h}x{w}_x{f:g}.png"
            cv2.imwrite(os.path.join(HERE, case["png"]), out)
        cases.append(case)
    for size, out_size in AREA_CASES:
        for kind in ("noise", "smooth"):
            img = pattern(size, size, kind)
            out = cv2.resize(img, (out_size, out_size),
                             interpolation=cv2.INTER_AREA)
            port = resize_u8(torch.from_numpy(img), (out_size, out_size),
                             "area").numpy()
            cases.append({"method": "area", "in": [size, size],
                          "out": [out_size, out_size], "kind": kind,
                          "input_sha256": sha(img), "sha256": sha(out),
                          "port_mismatch": int((port != out).sum())})
    manifest["resize"] = cases
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
