"""The port's dataset loaders (``tpusr_torch/data/loading.py``) against the
JAX package's (``tpusr/data/loading.py``) on the same PNG trees.

Tolerances: the decoded arrays, the padding, the patch windows and the
labels are equal bit for bit. After the ``srcnn`` loader's resize of the LR
up to the HR size the patches are within 1e-5: OpenCV sums each output in
float, the port in a float32 matrix product (``core/resize.py``), about
1e-6 apart on [0, 1]. ``INTER_NEAREST`` copies pixels and is exact.
"""

import os
import pickle

import cv2
import numpy as np
import pytest
from PIL import Image

from tpusr.data import loading as jl
from tpusr_torch.data import loading as tl

RESIZE_ATOL = 1e-5


def _write_pairs(root, n=4, hr=48, lr=24, seed=0, interp=None):
    """The JAX CLI tests' fixture: n blurred random HR images and their
    INTER_AREA LR, written as PNG by OpenCV, with the two maps."""
    hr_dir, lr_dir = root / "HR", root / "LR"
    hr_dir.mkdir()
    lr_dir.mkdir()
    rng = np.random.default_rng(seed)
    imap, cmap = {}, {}
    for i in range(n):
        img = (rng.random((hr, hr, 3)) * 255).astype(np.uint8)
        img = cv2.GaussianBlur(img, (3, 3), 1.0)
        small = cv2.resize(img, (lr, lr), interpolation=cv2.INTER_AREA)
        name = f"s_{i:03d}.png"
        cv2.imwrite(str(hr_dir / name), img)
        cv2.imwrite(str(lr_dir / name), small)
        imap[name] = interp[i % len(interp)] if interp else "INTER_CUBIC"
        cmap[name] = i % 2
    for fn, m in (("imap.pkl", imap), ("cmap.pkl", cmap)):
        with open(root / fn, "wb") as f:
            pickle.dump(m, f)
    return root


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return _write_pairs(tmp_path_factory.mktemp("pairs"))


def test_image_paths_keep_the_extensions_and_their_order(tmp_path):
    names = ["b.PNG", "a.png", "c.jpg", "d.jpeg", "e.bmp", "f.tiff", "g.tif",
             "h.gif", "i.txt", "sub/z.png", "sub/deeper/y.JPG", "A.Png"]
    for n in names:
        p = tmp_path / n
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    got = tl.get_all_image_paths(str(tmp_path))
    assert got == jl.get_all_image_paths(str(tmp_path))
    assert tl._IMG_EXTS == jl._IMG_EXTS
    assert [os.path.relpath(p, tmp_path) for p in got] == [
        "A.Png", "a.png", "b.PNG", "c.jpg", "d.jpeg", "e.bmp", "f.tiff",
        "sub/deeper/y.JPG", "sub/z.png"]


@pytest.mark.parametrize("shape,patch,stride", [
    ((48, 48, 3), 24, 12), ((50, 37, 3), 33, 14), ((24, 24, 3), 24, 12),
    ((96, 96, 3), 96, 48), ((30, 41, 1), 8, 5)])
def test_add_padding_equals_jax(shape, patch, stride):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    np.testing.assert_array_equal(tl.add_padding(img, patch, stride),
                                  jl.add_padding(img, patch, stride))


def test_scale_loader_equals_jax_bit_for_bit(pairs):
    for patch, stride, scale in ((12, 6, 2), (8, 4, 3), (24, 12, 2)):
        kw = dict(mode="scale", patch_size=patch, stride=stride,
                  scale_factor=scale)
        got = tl.load_dataset_as_patches(str(pairs / "HR"), str(pairs / "LR"), **kw)
        want = jl.load_dataset_as_patches(str(pairs / "HR"), str(pairs / "LR"), **kw)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_scale_loader_hr_windows_sit_at_stride_times_scale(pairs):
    x, y = tl.load_dataset_as_patches(str(pairs / "HR"), str(pairs / "LR"),
                                      mode="scale", patch_size=8, stride=4,
                                      scale_factor=2)
    hr = tl.add_padding(tl._imread_rgb01(str(pairs / "HR" / "s_000.png")), 16, 4)
    # LR grid of the padded 24^2 image: 28 -> (28 - 8) // 4 + 1 = 6 per side
    for k in (0, 1, 7, 35):
        i, j = divmod(k, 6)
        np.testing.assert_array_equal(y[k], hr[8 * i: 8 * i + 16, 8 * j: 8 * j + 16])


def test_srcnn_loader_equals_jax_after_the_resize(pairs):
    kw = dict(mode="srcnn", patch_size=24, stride=12,
              interpolation_map_path=str(pairs / "imap.pkl"))
    gx, gy, gh, gw = tl.load_dataset_as_patches(str(pairs / "HR"),
                                                str(pairs / "LR"), **kw)
    wx, wy, wh, ww = jl.load_dataset_as_patches(str(pairs / "HR"),
                                                str(pairs / "LR"), **kw)
    assert (gh, gw) == (wh, ww) == (48, 48)
    np.testing.assert_array_equal(gy, wy)
    assert gx.shape == wx.shape and gx.dtype == wx.dtype
    np.testing.assert_allclose(gx, wx, rtol=0, atol=RESIZE_ATOL)


# every name a degraded set's map holds, INTER_NEAREST, and the same five
# as cv2's int codes
INTERP_VALUES = ["INTER_LINEAR", "INTER_CUBIC", "INTER_AREA",
                 "INTER_LANCZOS4", "INTER_NEAREST", 0, 1, 2, 3, 4]


@pytest.mark.parametrize("value", INTERP_VALUES, ids=str)
def test_srcnn_loader_each_interpolation_equals_jax(tmp_path, value):
    root = _write_pairs(tmp_path, n=2, hr=40, lr=16, seed=3, interp=[value])
    kw = dict(mode="srcnn", patch_size=16, stride=8,
              interpolation_map_path=str(root / "imap.pkl"))
    gx, gy, *_ = tl.load_dataset_as_patches(str(root / "HR"), str(root / "LR"), **kw)
    wx, wy, *_ = jl.load_dataset_as_patches(str(root / "HR"), str(root / "LR"), **kw)
    np.testing.assert_array_equal(gy, wy)
    atol = 0.0 if tl.resolve_cv2_interp(value) == tl.INTER_NEAREST else RESIZE_ATOL
    np.testing.assert_allclose(gx, wx, rtol=0, atol=atol)


@pytest.mark.parametrize("value", INTERP_VALUES, ids=str)
def test_resize_cv2_equals_cv2_on_float32(value):
    code = tl.resolve_cv2_interp(value)
    assert code == jl.resolve_cv2_interp(value)
    img = np.random.default_rng(4).random((13, 17, 3)).astype(np.float32)
    for out_hw in ((52, 68), (29, 40), (13, 17)):
        want = cv2.resize(img, out_hw[::-1], interpolation=code)
        got = tl.resize_cv2(img, out_hw, code)
        atol = 0.0 if code == tl.INTER_NEAREST else RESIZE_ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_names_and_values_resolve_as_in_jax():
    for v in ("INTER_FOO", None, 2.5, "INTER_CUBIC", np.int64(3)):
        assert tl.resolve_cv2_interp(v) == jl.resolve_cv2_interp(v), v


@pytest.mark.parametrize("code", [5, 6, 7])
def test_other_interpolation_codes_raise_naming_the_code(tmp_path, code):
    root = _write_pairs(tmp_path, n=1, interp=[code])
    with pytest.raises(ValueError, match=f"interpolation code {code} "):
        tl.load_dataset_as_patches(str(root / "HR"), str(root / "LR"),
                                   mode="srcnn", patch_size=24, stride=12,
                                   interpolation_map_path=str(root / "imap.pkl"))


def test_defects_loader_equals_jax(pairs):
    for patch, stride, padded in ((16, 8, False), (32, 16, False),
                                  (16, 8, True)):
        kw = dict(patch_size=patch, stride=stride,
                  class_map_path=str(pairs / "cmap.pkl"), iterate_padded=padded)
        gx, gy = tl.load_defects_dataset_as_patches(str(pairs / "HR"), **kw)
        wx, wy = jl.load_defects_dataset_as_patches(str(pairs / "HR"), **kw)
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_defects_loader_iterates_the_unpadded_dims(tmp_path):
    """The reference's quirk: 81 patches of 96/48 from a 512^2 image, where
    the padded grid (the serving path's) has 100."""
    (tmp_path / "HR").mkdir()
    img = (np.random.default_rng(5).random((512, 512, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "HR" / "a.png"), img)
    with open(tmp_path / "c.pkl", "wb") as f:
        pickle.dump({"a.png": 1}, f)
    kw = dict(patch_size=96, stride=48, class_map_path=str(tmp_path / "c.pkl"))
    x, y = tl.load_defects_dataset_as_patches(str(tmp_path / "HR"), **kw)
    assert x.shape == (81, 96, 96, 3) and set(y.tolist()) == {1}
    xp, _ = tl.load_defects_dataset_as_patches(str(tmp_path / "HR"),
                                               iterate_padded=True, **kw)
    assert xp.shape[0] == 100
    np.testing.assert_array_equal(x, jl.load_defects_dataset_as_patches(
        str(tmp_path / "HR"), **kw)[0])


def test_predictions_loader_equals_jax(pairs):
    got = tl.load_predictions_dataset(str(pairs / "LR"), str(pairs / "HR"),
                                      str(pairs / "cmap.pkl"))
    want = jl.load_predictions_dataset(str(pairs / "LR"), str(pairs / "HR"),
                                       str(pairs / "cmap.pkl"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _raised(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - compared below
        return type(e), str(e)
    return None


def _error_cases(root, tmp):
    hr, lr, cmap = str(root / "HR"), str(root / "LR"), str(root / "cmap.pkl")
    empty = tmp / "empty"
    empty.mkdir(exist_ok=True)
    other = tmp / "other"
    (other / "HR").mkdir(parents=True, exist_ok=True)
    (other / "LR").mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(other / "HR" / "x.png"), np.zeros((8, 8, 3), np.uint8))
    cv2.imwrite(str(other / "LR" / "y.png"), np.zeros((4, 4, 3), np.uint8))
    notdict = tmp / "list.pkl"
    with open(notdict, "wb") as f:
        pickle.dump([1, 2], f)
    partial = tmp / "partial.pkl"
    with open(partial, "wb") as f:
        pickle.dump({"s_000.png": 0}, f)
    a_file = str(root / "cmap.pkl")
    return {
        "mode": ("load_dataset_as_patches", (hr, lr), dict(mode="x")),
        "missing_root": ("load_dataset_as_patches", (hr, str(tmp / "nope")), {}),
        "root_is_file": ("load_dataset_as_patches", (hr, a_file), {}),
        "patch_size": ("load_dataset_as_patches", (hr, lr), dict(patch_size=0)),
        "patch_float": ("load_dataset_as_patches", (hr, lr), dict(patch_size=2.0)),
        "stride": ("load_dataset_as_patches", (hr, lr), dict(stride=-1)),
        "scale": ("load_dataset_as_patches", (hr, lr),
                  dict(mode="scale", scale_factor=0)),
        "no_images": ("load_dataset_as_patches", (str(empty), lr), {}),
        "no_pairs": ("load_dataset_as_patches",
                     (str(other / "HR"), str(other / "LR")), {}),
        "defects_root": ("load_defects_dataset_as_patches", (str(tmp / "nope"),),
                         dict(class_map_path=cmap)),
        "defects_file": ("load_defects_dataset_as_patches", (a_file,),
                         dict(class_map_path=cmap)),
        "defects_patch": ("load_defects_dataset_as_patches", (hr,),
                          dict(patch_size=-3, class_map_path=cmap)),
        "defects_stride": ("load_defects_dataset_as_patches", (hr,),
                           dict(stride=0, class_map_path=cmap)),
        "defects_no_map": ("load_defects_dataset_as_patches", (hr,), {}),
        "defects_map_missing": ("load_defects_dataset_as_patches", (hr,),
                                dict(class_map_path=str(tmp / "nope.pkl"))),
        "defects_no_images": ("load_defects_dataset_as_patches", (str(empty),),
                              dict(class_map_path=cmap)),
        "defects_not_dict": ("load_defects_dataset_as_patches", (hr,),
                             dict(class_map_path=str(notdict))),
        "defects_missing_id": ("load_defects_dataset_as_patches", (hr,),
                               dict(class_map_path=str(partial))),
        "pred_lr_root": ("load_predictions_dataset", ("", hr, cmap), {}),
        "pred_hr_file": ("load_predictions_dataset", (lr, a_file, cmap), {}),
        "pred_no_map": ("load_predictions_dataset", (lr, hr, ""), {}),
        "pred_map_missing": ("load_predictions_dataset",
                             (lr, hr, str(tmp / "nope.pkl")), {}),
        "pred_no_lr": ("load_predictions_dataset", (str(empty), hr, cmap), {}),
        "pred_no_hr": ("load_predictions_dataset", (lr, str(empty), cmap), {}),
        "pred_not_dict": ("load_predictions_dataset", (lr, hr, str(notdict)), {}),
        "pred_no_pairs": ("load_predictions_dataset",
                          (str(other / "LR"), str(other / "HR"), cmap), {}),
        "pred_missing_id": ("load_predictions_dataset",
                            (lr, hr, str(partial)), {}),
    }


ERROR_CASES = [
    "mode", "missing_root", "root_is_file", "patch_size", "patch_float",
    "stride", "scale", "no_images", "no_pairs", "defects_root",
    "defects_file", "defects_patch", "defects_stride", "defects_no_map",
    "defects_map_missing", "defects_no_images", "defects_not_dict",
    "defects_missing_id", "pred_lr_root", "pred_hr_file", "pred_no_map",
    "pred_map_missing", "pred_no_lr", "pred_no_hr", "pred_not_dict",
    "pred_no_pairs", "pred_missing_id"]


@pytest.mark.parametrize("case", ERROR_CASES)
def test_argument_checks_raise_as_jax(pairs, tmp_path, case):
    fn, args, kwargs = _error_cases(pairs, tmp_path)[case]
    got = _raised(getattr(tl, fn), *args, **kwargs)
    want = _raised(getattr(jl, fn), *args, **kwargs)
    assert want is not None
    assert got == want


@pytest.mark.parametrize("fmt", ["jpg", "bmp", "tiff"])
def test_a_file_of_another_format_raises_naming_it(pairs, tmp_path, fmt):
    """A file the loader reaches and cannot decode (a BMP, a TIFF, a
    progressive JPEG) raises, naming the file and its format; it is not
    skipped (which would change the pairs and the split)."""
    hr_dir = tmp_path / "HR"
    hr_dir.mkdir()
    for f in os.listdir(pairs / "HR"):
        (hr_dir / f).write_bytes((pairs / "HR" / f).read_bytes())
    bad = hr_dir / f"s_001.{fmt}"
    cv2.imwrite(str(bad), np.zeros((48, 48, 3), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1] if fmt == "jpg" else [])
    os.remove(hr_dir / "s_001.png")
    name = {"jpg": "JPEG", "bmp": "BMP", "tiff": "TIFF"}[fmt]
    with open(tmp_path / "c.pkl", "wb") as f:
        pickle.dump({p: 0 for p in os.listdir(hr_dir)}, f)
    with pytest.raises(ValueError, match=f"s_001.{fmt}: a {name} image"):
        tl.load_defects_dataset_as_patches(str(hr_dir), patch_size=16,
                                           stride=8,
                                           class_map_path=str(tmp_path / "c.pkl"))


def test_an_unreadable_png_raises_naming_the_file(tmp_path):
    p = tmp_path / "broken.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 8)
    with pytest.raises(ValueError, match="broken.png"):
        tl._imread_rgb01(str(p))
    q = tmp_path / "noise.png"
    q.write_bytes(b"nothing")
    with pytest.raises(ValueError, match="Failed to read image: .*noise.png"):
        tl._imread_rgb01(str(q))


def _png_variants(tmp):
    """One PNG of each kind cv2 reduces to 8-bit BGR: 16-bit RGB and gray,
    8-bit gray, palette, RGBA and gray + alpha."""
    rng = np.random.default_rng(6)
    rgb = (rng.random((20, 23, 3)) * 255).astype(np.uint8)
    out = {}
    p = tmp / "rgb16.png"
    cv2.imwrite(str(p), (rng.random((20, 23, 3)) * 65535).astype(np.uint16))
    out["rgb16"] = p
    p = tmp / "gray16.png"
    cv2.imwrite(str(p), (rng.random((20, 23)) * 65535).astype(np.uint16))
    out["gray16"] = p
    p = tmp / "gray8.png"
    cv2.imwrite(str(p), rgb[..., 0])
    out["gray8"] = p
    p = tmp / "palette.png"
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=37).save(p)
    out["palette"] = p
    p = tmp / "rgba.png"
    cv2.imwrite(str(p), np.concatenate(
        [rgb, (rng.random((20, 23, 1)) * 255).astype(np.uint8)], -1))
    out["rgba"] = p
    p = tmp / "gray_alpha.png"
    Image.fromarray(np.stack([rgb[..., 1], rgb[..., 2]], -1), "LA").save(p)
    out["gray_alpha"] = p
    return out


@pytest.mark.parametrize("kind", ["rgb16", "gray16", "gray8", "palette",
                                  "rgba", "gray_alpha"])
def test_decode_equals_cv2_imread(tmp_path, kind):
    path = str(_png_variants(tmp_path)[kind])
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(tl.imread_rgb_u8(path), want)
    np.testing.assert_array_equal(tl._imread_rgb01(path), jl._imread_rgb01(path))
