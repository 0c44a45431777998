"""Host-side dataset builders (port of ``tpusr/data/loading.py``), with the
reference's semantics (``SRModels/loading_methods.py``):

- ``add_padding`` (:6-26), ``get_all_image_paths`` (:28-38);
- ``load_dataset_as_patches`` (:40-191), modes ``srcnn`` (the LR resized up
  to the HR size, patches over the padded dims) and ``scale`` (LR patch p,
  HR patch p*scale at (i*s*scale, j*s*scale));
- ``load_defects_dataset_as_patches`` (:194-285), which pads but iterates
  the *unpadded* dims (:275-277): 81 patches of 96/48 per 512^2 image, not
  the serving path's 100. The quirk is kept (``iterate_padded=False``);
- ``load_predictions_dataset`` (:288-386).

The JAX package decodes with ``cv2.imread`` and resizes with ``cv2.resize``.
The port has no image library: it decodes PNG with ``pipeline/png.py``
(what ``cv2.imread(IMREAD_COLOR)`` gives for 8- and 16-bit, gray, palette
and alpha PNGs) and baseline JPEG with ``pipeline/jpeg.py`` (bit for bit
what cv2 gives, EXIF orientation applied) and resizes with ``core/resize.py``'s cv2 taps, plus a
private ``INTER_NEAREST``. A file of another format that a loader reaches
raises, naming the file and its format: skipping it would change the pairs
and the split. Patches are cut with one numpy view per image.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from tpusr_torch.core.resize import resize
from tpusr_torch.pipeline.png import decode_image_u8, image_format

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff")

# OpenCV's interpolation codes
INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = range(5)
_INTERP_NAMES = {"INTER_LINEAR": INTER_LINEAR, "INTER_CUBIC": INTER_CUBIC,
                 "INTER_AREA": INTER_AREA, "INTER_LANCZOS4": INTER_LANCZOS4,
                 "INTER_NEAREST": INTER_NEAREST}
_RESIZE_METHODS = {INTER_LINEAR: "bilinear", INTER_CUBIC: "bicubic",
                   INTER_AREA: "area", INTER_LANCZOS4: "lanczos4"}


def add_padding(image: np.ndarray, patch_size: int, stride: int) -> np.ndarray:
    """loading_methods.py:6-26 parity (host numpy version)."""
    h, w = image.shape[:2]
    pad_h = (patch_size - (h % stride)) % stride if h % stride != 0 else 0
    pad_w = (patch_size - (w % stride)) % stride if w % stride != 0 else 0
    pad_h = max(pad_h, patch_size - stride)
    pad_w = max(pad_w, patch_size - stride)
    return np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")


def get_all_image_paths(root: str) -> list[str]:
    """loading_methods.py:28-38 parity."""
    paths = []
    for dirpath, _, filenames in os.walk(root):
        for fn in filenames:
            if fn.lower().endswith(_IMG_EXTS):
                paths.append(os.path.join(dirpath, fn))
    return sorted(paths)


def imread_rgb_u8(path: str) -> np.ndarray:
    """A PNG or baseline JPEG file as (h, w, 3) uint8 RGB, what
    ``cv2.imread(IMREAD_COLOR)`` and the BGR->RGB swap give; any other file
    raises ``ValueError`` naming it and its format."""
    with open(path, "rb") as f:
        body = f.read()
    fmt = image_format(body)
    if fmt not in ("PNG", "JPEG"):
        raise ValueError(
            f"{path}: a {fmt} image; the port's loaders decode PNG and "
            f"baseline JPEG only" if fmt
            else f"Failed to read image: {path} (not a PNG or JPEG)")
    try:
        return decode_image_u8(body)
    except ValueError as e:
        raise ValueError(f"{path}: a {fmt} image the port cannot decode "
                         f"({e})") from None


def _imread_rgb01(path: str) -> np.ndarray:
    return imread_rgb_u8(path).astype(np.float32) / 255.0


def _sliding_patches(img: np.ndarray, patch: int, stride: int,
                     limit_hw: tuple[int, int] | None = None) -> np.ndarray:
    """All patches at (i*stride, j*stride) with i,j bounded by limit_hw (or the
    image itself). Vectorized equivalent of the reference's double loop."""
    h, w = img.shape[:2]
    lim_h, lim_w = limit_hw if limit_hw is not None else (h, w)
    nh = max(0, (lim_h - patch) // stride + 1)
    nw = max(0, (lim_w - patch) // stride + 1)
    if nh == 0 or nw == 0:
        return np.empty((0, patch, patch, img.shape[2]), img.dtype)
    s0, s1, s2 = img.strides
    view = np.lib.stride_tricks.as_strided(
        img, shape=(nh, nw, patch, patch, img.shape[2]),
        strides=(s0 * stride, s1 * stride, s0, s1, s2), writeable=False)
    return view.reshape(nh * nw, patch, patch, img.shape[2]).copy()


def resolve_cv2_interp(value) -> int:
    """Map an interpolation_map entry to an OpenCV interpolation code. A
    name goes through the table (an unknown name becomes bicubic, as in the
    JAX package); an int passes through unchanged, as the reference hands
    codes straight to cv2.resize; anything else is bicubic."""
    if isinstance(value, str):
        return _INTERP_NAMES.get(value, INTER_CUBIC)
    if isinstance(value, (int, np.integer)):
        return int(value)
    return INTER_CUBIC


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index of each output index:
    ``min(floor(dx * in / out), in - 1)``."""
    return np.minimum(np.floor(np.arange(out_size) * (in_size / out_size))
                      .astype(np.int64), in_size - 1)


def resize_cv2(img: np.ndarray, out_hw: tuple[int, int], code: int
               ) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=code)`` on an (h, w, c)
    float32 image, for the codes the reference's maps hold (0-4); any other
    code raises, naming it."""
    if code == INTER_NEAREST:
        rows = _nearest_index(img.shape[0], out_hw[0])
        cols = _nearest_index(img.shape[1], out_hw[1])
        return img[rows][:, cols]
    if code not in _RESIZE_METHODS:
        raise ValueError(
            f"interpolation code {code} is not one the port resizes with "
            f"(0 INTER_NEAREST, 1 INTER_LINEAR, 2 INTER_CUBIC, 3 INTER_AREA, "
            f"4 INTER_LANCZOS4)")
    with torch.no_grad():
        out = resize(torch.from_numpy(np.ascontiguousarray(img, np.float32)),
                     out_hw, _RESIZE_METHODS[code])
    return out.numpy()


def load_dataset_as_patches(hr_root, lr_root, mode="srcnn", patch_size=33,
                            stride=14, scale_factor=2,
                            interpolation_map_path=None):
    """loading_methods.py:40-191 parity. Returns (X, Y) or (X, Y, hr_h, hr_w)."""
    if mode not in ("srcnn", "scale"):
        raise ValueError("mode must be 'srcnn' or 'scale'")
    if not os.path.exists(hr_root) or not os.path.exists(lr_root):
        raise ValueError("Both HR and LR root directories must exist.")
    if not os.path.isdir(hr_root) or not os.path.isdir(lr_root):
        raise ValueError("Both HR and LR root paths must be directories.")
    if not isinstance(patch_size, int) or patch_size <= 0:
        raise ValueError("patch_size must be positive int.")
    if not isinstance(stride, int) or stride <= 0:
        raise ValueError("stride must be positive int.")
    if mode == "scale" and (not isinstance(scale_factor, int) or scale_factor <= 0):
        raise ValueError("scale_factor must be positive int.")

    hr_paths = get_all_image_paths(hr_root)
    lr_paths = get_all_image_paths(lr_root)
    if not hr_paths or not lr_paths:
        raise ValueError("No images found in provided directories.")
    hr_dict = {os.path.basename(p): p for p in hr_paths}
    lr_dict = {os.path.basename(p): p for p in lr_paths}
    common = sorted(set(hr_dict) & set(lr_dict))
    if not common:
        raise ValueError(
            "No matching basenames found between HR and LR roots (pairs are "
            "matched by filename, like the predictions loader).")

    interpolation_map = None
    if mode == "srcnn" and interpolation_map_path is not None:
        with open(interpolation_map_path, "rb") as f:
            interpolation_map = pickle.load(f)

    xs, ys = [], []
    hr_h = hr_w = None
    for fname in common:
        hr_img = _imread_rgb01(hr_dict[fname])
        lr_img = _imread_rgb01(lr_dict[fname])
        hr_h, hr_w = hr_img.shape[:2]

        if mode == "srcnn":
            code = INTER_CUBIC
            if interpolation_map is not None:
                code = resolve_cv2_interp(
                    interpolation_map.get(fname, "INTER_CUBIC"))
            lr_up = np.clip(resize_cv2(lr_img, (hr_h, hr_w), code), 0.0, 1.0)
            hr_proc = add_padding(hr_img, patch_size, stride)
            lr_proc = add_padding(lr_up, patch_size, stride)
            # iterate over padded dims (reference :154-156)
            xs.append(_sliding_patches(lr_proc, patch_size, stride))
            ys.append(_sliding_patches(hr_proc, patch_size, stride))
        else:
            p_hr = patch_size * scale_factor
            hr_proc = add_padding(hr_img, p_hr, stride)
            lr_proc = add_padding(lr_img, patch_size, stride)
            lr_p = _sliding_patches(lr_proc, patch_size, stride)
            # HR patches at (i*s*scale, j*s*scale) with i,j from the LR grid;
            # a window that leaves the padded HR image is dropped with its LR
            # patch (the reference's shape guard, :180-184)
            lrH, lrW = lr_proc.shape[:2]
            nh = (lrH - patch_size) // stride + 1
            nw = (lrW - patch_size) // stride + 1
            hr_list = []
            keep = []
            for k in range(nh * nw):
                i, j = divmod(k, nw)
                hi, hj = i * stride * scale_factor, j * stride * scale_factor
                hp = hr_proc[hi:hi + p_hr, hj:hj + p_hr]
                if hp.shape[:2] == (p_hr, p_hr):
                    hr_list.append(hp)
                    keep.append(k)
            xs.append(lr_p[keep])
            ys.append(np.stack(hr_list) if hr_list else
                      np.empty((0, p_hr, p_hr, 3), np.float32))

    x_arr = np.concatenate(xs) if xs else np.empty((0,))
    y_arr = np.concatenate(ys) if ys else np.empty((0,))
    if mode == "srcnn":
        return x_arr, y_arr, hr_h, hr_w
    return x_arr, y_arr


def _read_class_map(class_map_path: str) -> dict:
    with open(class_map_path, "rb") as f:
        class_labels_map = pickle.load(f)
    if not isinstance(class_labels_map, dict):
        raise ValueError("class_labels_map pickle must contain a dict of "
                         "{basename: class_id}.")
    return class_labels_map


def _check_class_map_path(class_map_path) -> None:
    if not class_map_path or not isinstance(class_map_path, str):
        raise ValueError("class_map_path must be a non-empty string.")
    if not os.path.exists(class_map_path):
        raise FileNotFoundError(f"Class labels map not found: {class_map_path}")


def load_defects_dataset_as_patches(hr_root, patch_size=33, stride=14,
                                    class_map_path=None, iterate_padded=False):
    """loading_methods.py:194-285 parity. By default reproduces the reference's
    quirk of iterating the UN-padded image dims (:275-277)."""
    if not os.path.exists(hr_root):
        raise ValueError("HR root directory must exist.")
    if not os.path.isdir(hr_root):
        raise ValueError("HR root path must be a directory.")
    if not isinstance(patch_size, int) or patch_size <= 0:
        raise ValueError("patch_size must be positive int.")
    if not isinstance(stride, int) or stride <= 0:
        raise ValueError("stride must be positive int.")
    _check_class_map_path(class_map_path)

    hr_paths = get_all_image_paths(hr_root)
    if not hr_paths:
        raise ValueError("No images found under HR root directory.")
    class_labels_map = _read_class_map(class_map_path)
    hr_paths = sorted(hr_paths, key=os.path.basename)

    xs, ys = [], []
    for path in hr_paths:
        img = _imread_rgb01(path)
        hr_h, hr_w = img.shape[:2]
        base = os.path.basename(path)
        if base not in class_labels_map:
            raise KeyError(f"Missing class id for image basename in "
                           f"class_labels_map: {base}")
        class_id = int(class_labels_map[base])
        proc = add_padding(img, patch_size, stride)
        limit = None if iterate_padded else (hr_h, hr_w)
        patches = _sliding_patches(proc, patch_size, stride, limit_hw=limit)
        xs.append(patches)
        ys.append(np.full((patches.shape[0],), class_id, np.int64))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys))


def load_predictions_dataset(lr_root: str, hr_root: str, class_map_path: str):
    """loading_methods.py:288-386 parity: full aligned LR/HR pairs + labels."""
    for root, nm in ((lr_root, "lr_root"), (hr_root, "hr_root")):
        if not root or not isinstance(root, str) or not os.path.exists(root):
            raise ValueError(f"{nm} must be an existing directory path.")
        if not os.path.isdir(root):
            raise ValueError(f"{nm} must be a directory.")
    _check_class_map_path(class_map_path)

    lr_paths = get_all_image_paths(lr_root)
    hr_paths = get_all_image_paths(hr_root)
    if not lr_paths:
        raise ValueError("No images found under LR root directory.")
    if not hr_paths:
        raise ValueError("No images found under HR root directory.")
    class_labels_map = _read_class_map(class_map_path)
    lr_dict = {os.path.basename(p): p for p in lr_paths}
    hr_dict = {os.path.basename(p): p for p in hr_paths}
    common = sorted(set(lr_dict) & set(hr_dict))
    if not common:
        raise ValueError("No matching basenames found between LR and HR roots.")

    x_lr, x_hr, y = [], [], []
    for base in common:
        if base not in class_labels_map:
            raise KeyError(f"Missing class id for basename in class_labels_map: {base}")
        x_lr.append(_imread_rgb01(lr_dict[base]))
        x_hr.append(_imread_rgb01(hr_dict[base]))
        y.append(int(class_labels_map[base]))
    return (np.array(x_lr, np.float32), np.array(x_hr, np.float32),
            np.array(y, np.int64))
