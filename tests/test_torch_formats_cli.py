"""The formats the port reads now (BMP, TIFF, progressive JPEG, Adam7 PNG)
through what reads them, against the JAX package, which reads them with
cv2 (CPU, ``--device cpu``):

- the loaders: ``load_dataset_as_patches`` and
  ``load_defects_dataset_as_patches`` of both packages on one dataset
  written as ``.bmp``, as ``.tiff`` (LZW) and as progressive ``.jpg``: the
  arrays are equal;
- ``classic`` on the ``.tiff`` and ``.bmp`` datasets: the JAX command's
  JSON as ``test_torch_cli.py`` holds it on PNGs, and the port's
  JSON equal to its own on the PNG twins (times and memory aside);
- ``eda`` on progressive-JPEG pairs: the JAX command's CSVs.

The HTTP tier's formats are in ``test_torch_http_serving.py``
(``test_http_tier_answers_each_format_as_its_png_twin``).
"""

import json
import math
import os
import pickle

import cv2
import numpy as np
import pytest

import tpusr.cli.__main__ as jcli
import tpusr.data.loading as jl
import tpusr_torch.cli.__main__ as tcli
import tpusr_torch.data.loading as tl
from test_torch_cli import record_figures
from test_torch_data import RESIZE_ATOL, _write_pairs
from torch_image_writers import write_tiff

FORMATS = ("bmp", "tiff", "jpg")


def _write_as(src, dst, fmt):
    """The PNG pairs under ``src`` rewritten under ``dst`` as ``fmt``: a
    cv2 BMP, an LZW TIFF with predictor 2 (hand-written), a progressive
    cv2 JPEG; the maps renamed to match."""
    for d in ("HR", "LR"):
        os.makedirs(dst / d)
        for f in sorted(os.listdir(src / d)):
            bgr = cv2.imread(str(src / d / f))
            out = dst / d / f.replace(".png", f".{fmt}")
            if fmt == "tiff":
                out.write_bytes(write_tiff(bgr[..., ::-1], compression=5,
                                           predictor=2, rows_per_strip=8))
            else:
                assert cv2.imwrite(str(out), bgr, [
                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                    cv2.IMWRITE_JPEG_QUALITY, 90])
    for m in ("cmap.pkl", "imap.pkl"):
        with open(src / m, "rb") as f:
            table = {n.replace(".png", f".{fmt}"): v
                     for n, v in pickle.load(f).items()}
        with open(dst / m, "wb") as f:
            pickle.dump(table, f)
    return dst


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("formats")
    (root / "png").mkdir()
    src = _write_pairs(root / "png")
    return {"png": src, **{fmt: _write_as(src, root / fmt, fmt)
                           for fmt in FORMATS}}


@pytest.mark.parametrize("fmt", FORMATS)
def test_loaders_read_the_format_as_jax(datasets, fmt):
    d = datasets[fmt]
    hr, lr = str(d / "HR"), str(d / "LR")
    kw = dict(mode="scale", patch_size=12, stride=6, scale_factor=2)
    for g, w in zip(tl.load_dataset_as_patches(hr, lr, **kw),
                    jl.load_dataset_as_patches(hr, lr, **kw)):
        np.testing.assert_array_equal(g, w)
    # srcnn mode resizes the float LR: within the float resize's tolerance
    kw = dict(mode="srcnn", patch_size=16, stride=8, scale_factor=2)
    gx, gy, *g_hw = tl.load_dataset_as_patches(hr, lr, **kw)
    wx, wy, *w_hw = jl.load_dataset_as_patches(hr, lr, **kw)
    assert g_hw == w_hw
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_allclose(gx, wx, rtol=0, atol=RESIZE_ATOL)
    kw = dict(patch_size=16, stride=8, class_map_path=str(d / "cmap.pkl"))
    for g, w in zip(tl.load_defects_dataset_as_patches(hr, **kw),
                    jl.load_defects_dataset_as_patches(hr, **kw)):
        np.testing.assert_array_equal(g, w)


def _summary(path):
    with open(path) as f:
        got = json.load(f)
    return {alg: {k: v for k, v in row.items()
                  if not k.startswith(("time_", "memory_"))}
            for alg, row in got["summary"].items()}


def test_classic_on_tiff_and_bmp_equals_jax_and_the_png_run(datasets,
                                                            tmp_path,
                                                            monkeypatch):
    """The port's JSON on the ``.tiff`` and ``.bmp`` datasets equals its
    JSON on the PNG twins, and the JAX command's on the ``.tiff`` one as
    ``test_torch_cli.py`` holds it on PNGs. cv2 reads the ``.bmp`` files
    to the ``.tiff`` files' pixels, so the JAX command's JSON on them is
    the same (it reads with ``cv2.imread``)."""
    from test_torch_cli import RTOL
    record_figures(monkeypatch)

    def argv(name):
        d = datasets[name]
        return ["classic", "--hr-dir", str(d / "HR"), "--lr-dir",
                str(d / "LR"), "--fraction", "1.0", "--limit", "2"]

    outs = {}
    for name in ("tiff", "bmp", "png"):
        tcli.main(argv(name) + ["--out", str(tmp_path / name), "--device",
                                "cpu"])
        outs[name] = _summary(tmp_path / name / "classic_summary.json")
    assert outs["tiff"] == outs["bmp"] == outs["png"]
    for d in ("HR", "LR"):
        for f in sorted(os.listdir(datasets["tiff"] / d)):
            stem = f.rsplit(".", 1)[0]
            np.testing.assert_array_equal(
                cv2.imread(str(datasets["tiff"] / d / f)),
                cv2.imread(str(datasets["bmp"] / d / f"{stem}.bmp")))
    jcli.main(argv("tiff") + ["--out", str(tmp_path / "j")])
    want = _summary(tmp_path / "j" / "classic_summary.json")
    assert sorted(want) == sorted(outs["tiff"])
    for alg, w in want.items():
        assert sorted(w) == sorted(outs["tiff"][alg])
        for k, v in w.items():
            atol = 0.0
            if k.endswith("_var"):      # as test_classic_summary_equals_jax
                d = RTOL * abs(w[k[:-4] + "_mean"])
                atol = 2 * math.sqrt(v) * d + d * d
            np.testing.assert_allclose(outs["tiff"][alg][k], v, rtol=RTOL,
                                       atol=atol, err_msg=f"{alg} {k}")


def test_eda_on_progressive_jpeg_pairs_writes_the_jax_csvs(tmp_path,
                                                           monkeypatch):
    from test_torch_eda import assert_csv_close, write_eda_pairs
    import tpusr.data.eda as jeda

    root = write_eda_pairs(str(tmp_path / "png"), n=3)
    prog = tmp_path / "prog"
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        os.makedirs(prog / rel, exist_ok=True)
        for f in files:
            src = os.path.join(dirpath, f)
            if f.endswith(".pkl"):
                with open(src, "rb") as fh:
                    table = {n.rsplit(".", 1)[0] + ".jpg": v
                             for n, v in pickle.load(fh).items()}
                with open(prog / rel / f, "wb") as fh:
                    pickle.dump(table, fh)
                continue
            assert cv2.imwrite(str(prog / rel / (f.rsplit(".", 1)[0] + ".jpg")),
                               cv2.imread(src), [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                                 1, cv2.IMWRITE_JPEG_QUALITY, 85])
    # no LPIPS weights (the decode is what differs from the PNG runs):
    # both commands leave the column empty
    monkeypatch.delenv("TPUSR_LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jeda, "_lpips_mod", None)
    monkeypatch.setattr(jeda, "_LPIPS_JAX_W", None)
    record_figures(monkeypatch)
    common = ["--hr-dir", str(prog / "HR"), "--lr-dir", str(prog / "LR"),
              "--interp-map", str(prog / "imap.pkl")]
    jcli.main(["eda", *common, "--out", str(tmp_path / "jax")])
    tcli.main(["eda", *common, "--out", str(tmp_path / "port"), "--device",
               "cpu"])
    for name in ("eda_metrics.csv", "eda_summary.csv"):
        assert_csv_close(tmp_path / "port" / name, tmp_path / "jax" / name)
    with open(tmp_path / "port" / "eda_metrics.csv") as f:
        assert len(f.read().splitlines()) == 4        # three pairs, a header
