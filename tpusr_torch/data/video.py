"""Video -> HR/LR pairs (port of ``tpusr/data/video.py``; reference
``data/common_methods.py:4-49`` and ``preprocessing_functions.ipynb`` cells
2 and 5): frames sampled by ``skip_seconds`` / ``frame_interval_seconds``,
the smart square crop, an optional ``INTER_AREA`` resize to ``hr_size``
(else an odd crop is trimmed to even), the degradation, the aligned PNG
pairs and the sidecar pickles (``interpolation_map.pkl``: name -> interp
name; ``class_labels_map.pkl``: name -> class id), numbering continued from
the files already there.

The video is read by the port's own readers, which give the frames
``cv2.VideoCapture`` gives (``open_video``, by the file's magic bytes):
AVI (``data/avi.py``) with MJPEG or MPEG-4 Part 2 (``FMP4``/``XVID``/
``DIVX``), MP4/QuickTime ``.mp4``/``.mov`` (``data/isobmff.py``) with
MPEG-4 Part 2 (``mp4v``, ``data/mpeg4.py``), and Matroska/WebM
``.mkv``/``.webm`` (``data/matroska.py``) with VP8 (``data/vp8video.py``),
MPEG-4 Part 2 or MJPEG: what ``cv2.VideoWriter`` writes. An MPEG-4 or VP8
stream decodes every frame in order (each predicts the next) and converts
to BGR only the frames the extractor samples. The
crop's OpenCV ops are the port's own (``data/_cv_ops.py``: gray and Otsu
on the frame's device, the contours on the host); the resize is
``_cv_ops.resize_u8`` (cv2's uint8 ``INTER_AREA``); the degradation core
runs on ``device`` with JAX's draws (``key, sub = split(key)`` from
``PRNGKey(seed)`` for each written frame, as the JAX command draws) and
the JPEG round trip on the host; the PNGs are ``pipeline/png.py``'s.

``create_hr_lr_images_from_frames`` is the frame loop below the reader: an
iterable of BGR frames (or of callables that decode one) and the rate, and
optionally the draws, so that the loop can be run on any frames and any
draws.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from tpusr_torch.core import prng
from tpusr_torch.data import _cv_ops as cv
from tpusr_torch.data import isobmff, matroska
from tpusr_torch.data.avi import read_avi
from tpusr_torch.data.degrade import (DegradeConfig, degrade_with_draws,
                                      sample_draws)
from tpusr_torch.device import resolve_device
from tpusr_torch.pipeline.png import encode_png_u8


def smart_square_crop(img):
    """Otsu threshold + the largest external contour's centred square crop
    (common_methods.py:4-49) of an (h, w, 3) uint8 BGR image, a numpy array
    or a tensor; returns a view of it."""
    h, w = img.shape[:2]
    crop_size = min(w, h)
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(img))
    _, mask = cv.otsu_threshold(cv.bgr2gray(t))
    contours = cv.external_contours(mask)
    if contours:
        areas = [cv.contour_area(c) for c in contours]
        largest = contours[areas.index(max(areas))]     # the first of equals
        x, y, ww, hh = cv.bounding_rect(largest)
        cx, cy = x + ww // 2, y + hh // 2
        half = crop_size // 2
        left = max(0, cx - half)
        top = max(0, cy - half)
        if left + crop_size > w:
            left = w - crop_size
        if top + crop_size > h:
            top = h - crop_size
        left, top = max(0, left), max(0, top)
        return img[top:top + crop_size, left:left + crop_size]
    left = (w - crop_size) // 2
    top = (h - crop_size) // 2
    return img[top:top + crop_size, left:left + crop_size]


def open_video(path: str):
    """The video at ``path``, by its magic bytes (never its extension):
    an object with ``fps``, ``len()``, ``frame(i)`` and ``frames()`` (an
    ``avi.AviVideo``, an ``mpeg4.Mpeg4Video`` or a ``vp8video.Vp8Video``)."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[4:8] in isobmff.MAGIC:
        return isobmff.read_mp4(path)
    if head[:4] == matroska.MAGIC:
        return matroska.read_mkv(path)
    return read_avi(path)


def _next_index(directory: str, prefix: str) -> int:
    """Continue numbering from existing files (preprocessing cell 2
    behavior)."""
    if not os.path.isdir(directory):
        return 0
    best = -1
    for fn in os.listdir(directory):
        if fn.startswith(prefix) and fn.endswith(".png"):
            try:
                best = max(best, int(fn[len(prefix):-4].strip("_")))
            except ValueError:
                continue
    return best + 1


def _load_map(path: str | None) -> dict:
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    return {}


def create_hr_lr_images_from_frames(
    frames,
    fps: float,
    hr_dir: str,
    lr_dir: str,
    skip_seconds: float = 0.0,
    frame_interval_seconds: float = 1.0,
    hr_size: int | None = None,
    prefix: str = "sample",
    interpolation_map_path: str | None = None,
    class_labels_map_path: str | None = None,
    class_id: int | None = None,
    degrade_cfg: DegradeConfig = DegradeConfig(),
    seed: int = 0,
    max_frames: int | None = None,
    device="cuda",
    key=None,
    draws_fn=None,
):
    """The frame loop of ``create_hr_lr_images_from_video`` on ``frames``
    (BGR uint8 arrays, or callables returning one) at ``fps`` (0 reads as
    30, as ``CAP_PROP_FPS or 30.0``). ``draws_fn(hr_shape)``, when given,
    supplies each written pair's ``DegradeDraws`` in place of the draws
    from ``key`` (default ``PRNGKey(seed)``). Returns the written
    basenames."""
    dev = resolve_device(device)
    os.makedirs(hr_dir, exist_ok=True)
    os.makedirs(lr_dir, exist_ok=True)
    fps = fps or 30.0
    skip_frames = int(skip_seconds * fps)
    step = max(1, int(frame_interval_seconds * fps))
    interp_map = _load_map(interpolation_map_path)
    class_map = _load_map(class_labels_map_path)
    if key is None:
        key = prng.PRNGKey(seed)

    idx = _next_index(hr_dir, prefix)
    written = []
    for frame_no, frame in enumerate(frames):
        if frame_no < skip_frames or (frame_no - skip_frames) % step != 0:
            continue
        if callable(frame):
            frame = frame()
        crop = smart_square_crop(torch.from_numpy(np.ascontiguousarray(
            frame)).to(dev))
        if hr_size is not None:
            crop = cv.resize_u8(crop, (hr_size, hr_size), "area")
        elif crop.shape[0] % 2:
            # the x0.5 degradation truncates: an odd HR (e.g. 607) yields a
            # 303 LR with 303*2 != 607, misaligning every 'scale' mode patch
            # pair; trim to even instead
            crop = crop[:-1, :-1]
        hr01 = crop.flip(-1).to(torch.float32) / 255.0
        shape = tuple(hr01.shape)
        key, sub = prng.split(key)
        draws = (draws_fn(shape) if draws_fn is not None
                 else sample_draws(sub, shape, degrade_cfg, dev))
        lr01, interp_name = degrade_with_draws(hr01, draws, degrade_cfg,
                                               apply_jpeg=True)

        name = f"{prefix}_{idx:05d}.png"
        hr_u8 = (hr01.cpu().numpy() * 255).round().astype(np.uint8)
        lr_u8 = (lr01.cpu().numpy() * 255).round().astype(np.uint8)
        for d, u8 in ((hr_dir, hr_u8), (lr_dir, lr_u8)):
            with open(os.path.join(d, name), "wb") as f:
                f.write(encode_png_u8(u8))
        if interpolation_map_path:
            interp_map[name] = interp_name
        if class_labels_map_path and class_id is not None:
            class_map[name] = int(class_id)
        written.append(name)
        idx += 1
        if max_frames is not None and len(written) >= max_frames:
            break

    if interpolation_map_path:
        with open(interpolation_map_path, "wb") as f:
            pickle.dump(interp_map, f)
    if class_labels_map_path and class_id is not None:
        with open(class_labels_map_path, "wb") as f:
            pickle.dump(class_map, f)
    return written


def create_hr_lr_images_from_video(
    video_path: str,
    hr_dir: str,
    lr_dir: str,
    skip_seconds: float = 0.0,
    frame_interval_seconds: float = 1.0,
    hr_size: int | None = None,
    prefix: str = "sample",
    interpolation_map_path: str | None = None,
    class_labels_map_path: str | None = None,
    class_id: int | None = None,
    degrade_cfg: DegradeConfig = DegradeConfig(),
    seed: int = 0,
    max_frames: int | None = None,
    device="cuda",
    key=None,
):
    """Sample frames -> smart crop -> (optional resize) -> degrade -> write
    aligned HR/LR PNG pairs; persist the sidecar pickles. Returns the
    written basenames (preprocessing_functions.ipynb cell 2; pass
    ``interpolation_map_path=None`` and class ids for the prediction
    variant, cell 5)."""
    if not os.path.exists(video_path):
        raise FileNotFoundError(video_path)
    try:
        video = open_video(video_path)
    except ValueError as e:
        raise ValueError(f"could not open video (the port reads MJPEG or "
                         f"MPEG-4 Part 2 in AVI, MPEG-4 Part 2 in "
                         f"MP4/QuickTime, and VP8, MPEG-4 Part 2 or MJPEG "
                         f"in Matroska/WebM): {e}") from None
    return create_hr_lr_images_from_frames(
        video.frames(), video.fps, hr_dir, lr_dir, skip_seconds=skip_seconds,
        frame_interval_seconds=frame_interval_seconds, hr_size=hr_size,
        prefix=prefix, interpolation_map_path=interpolation_map_path,
        class_labels_map_path=class_labels_map_path, class_id=class_id,
        degrade_cfg=degrade_cfg, seed=seed, max_frames=max_frames,
        device=device, key=key)


def create_hr_lr_prediction_images_from_video(video_path, hr_dir, lr_dir,
                                              class_id=None,
                                              predictions_class_map_path=None,
                                              **kwargs):
    """Prediction-set variant (cell 5): the same flow, no interpolation
    map, an optional predictions class map."""
    return create_hr_lr_images_from_video(
        video_path, hr_dir, lr_dir,
        interpolation_map_path=None,
        class_labels_map_path=predictions_class_map_path,
        class_id=class_id, **kwargs)
