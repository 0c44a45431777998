"""Write the JPEG fixtures beside this file, cv2's decode of each as a PNG
(``<name>.png``; the 512^2 one only as a hash) and ``decoded.json`` (each
decode's shape and the sha256 of its RGB bytes), for checks on a machine
that has no OpenCV (``chip_smoke.py``'s EDA phase) and for
``tests/test_torch_jpeg.py``.

    python tests/data/jpeg/make_fixtures.py

Needs OpenCV; the images are drawn from a fixed numpy seed.
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def scene(rng, h, w, channels=3):
    """A smooth random field with sensor-like noise, uint8 (h, w, c)."""
    x = rng.normal(size=(h // 8 + 2, w // 8 + 2, channels)).cumsum(0).cumsum(1)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    x = (x - x.min()) / (np.ptp(x) + 1e-9) * 235 + 10
    x = x + rng.normal(scale=6, size=x.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def exif_app1(orientation: int) -> bytes:
    """An APP1 Exif segment with one IFD0 entry, the orientation tag."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def encode(bgr, quality=90, sampling="420", restart=0, progressive=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if bgr.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, buf = cv2.imencode(".jpg", bgr, params)
    assert ok
    return buf.tobytes()


def fixtures() -> dict[str, bytes]:
    """name -> JPEG bytes; the EDA pair is ``eda_hr``/``eda_lr``."""
    rng = np.random.default_rng(2024)
    img = scene(rng, 83, 97)
    hr = scene(rng, 128, 128)
    lr = cv2.resize(hr, (32, 32), interpolation=cv2.INTER_AREA)
    big = scene(rng, 512, 512)
    base = encode(img, 90, "420")
    return {
        "q50_444": encode(img, 50, "444"),
        "q75_422": encode(img, 75, "422"),
        "q95_420": encode(img, 95, "420"),
        "q100_420_rst": encode(img, 100, "420", restart=2),
        "gray_q85": encode(img[..., 1], 85),
        "exif6_420": base[:2] + exif_app1(6) + base[2:],
        "progressive": encode(img, 90, "420", progressive=True),
        "eda_hr": encode(hr, 90, "420"),
        "eda_lr": encode(lr, 90, "420"),
        "q90_512": encode(big, 90, "420"),
    }


def main():
    decoded = {}
    for name, body in fixtures().items():
        with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
            f.write(body)
        if name == "progressive":     # the decoder refuses it
            continue
        bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        decoded[name] = {"shape": list(rgb.shape),
                         "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
        if name != "q90_512":         # too large to keep as a PNG
            cv2.imwrite(os.path.join(HERE, f"{name}.png"), bgr)
    with open(os.path.join(HERE, "decoded.json"), "w") as f:
        json.dump(decoded, f, indent=1, sort_keys=True)
    print(f"wrote {len(decoded) + 1} JPEG fixtures to {HERE}")


if __name__ == "__main__":
    main()
