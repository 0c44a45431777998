"""The port's EDA figures (the nine plotting functions of
``tpusr_torch/data/eda.py``) against the JAX package's (``tpusr/data/eda.py``,
matplotlib and pandas) on the CPU, with the recorders and comparisons of
``test_torch_viz.py``; the statistics they draw against the libraries the
JAX package uses (``boxplot_stats`` against matplotlib's, ``correlation``
against pandas' ``DataFrame.corr()``, NaN cells included, ``hist`` of a
uint8 tensor against ``Axes.hist``); ``run_eda_pipeline``'s files against
the JAX pipeline's names; and the uint8 linear and Lanczos4 shrinks of
``resize_u8`` against ``cv2.resize``, value for value.

The spectra, Sobel magnitude and noise map are torch ops on the CPU device
here, held at rtol 1e-5 / atol 1e-6; the rest at rtol 1e-12.
"""

from __future__ import annotations

import math
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

import tpusr.data.eda as jeda
from test_torch_eda import _smooth, jax_with_lpips, write_eda_pairs
from test_torch_viz import (MAP_TOL, MplRecorder, PortRecorder, assert_file,
                            assert_same, assert_same_figures)
from tpusr_torch.data import _cv_ops as ops
from tpusr_torch.data import eda as teda


@pytest.fixture(scope="module")
def eda_ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz_eda")
    write_eda_pairs(str(root), n=6)
    return root


@pytest.fixture(scope="module")
def table(eda_ds):
    """The port's rows and ``gd`` of the dataset, with LPIPS values, a NaN
    and a column constant over the pairs (pandas' NaN correlation)."""
    rows, gd = teda.collect_metrics(str(eda_ds / "LR"), str(eda_ds / "HR"),
                                    device="cpu")
    rng = np.random.default_rng(0)
    for r in rows:
        r["lpips"] = float(rng.random())
        r["ch2_kurt_hr"] = 1.5
    rows[2]["lpips"] = None
    rows[3]["ringing_lr"] = math.nan
    return rows, gd


def _frame(rows):
    import pandas as pd
    return pd.DataFrame(rows)


def _pair(eda_ds, name="p0.png"):
    lr, hr = teda.load_and_align(str(eda_ds / "LR" / name),
                                 str(eda_ds / "HR" / name), device="cpu")
    return lr, hr


@pytest.mark.parametrize("fn", ["basic_distributions", "artifact_color_histograms",
                                "artifact_boxplots", "channel_shape_bars",
                                "correlation_matrix", "scatter_relations"])
@pytest.mark.parametrize("lpips", [True, False], ids=["lpips", "no_lpips"])
def test_table_figures_equal_jax(table, tmp_path, monkeypatch, fn, lpips):
    rows, _ = table
    if not lpips:
        rows = [{**r, "lpips": None} for r in rows]
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    for d in ("j", "t"):
        os.makedirs(tmp_path / d)
    getattr(jeda, fn)(_frame(rows), str(tmp_path / "j"))
    getattr(teda, fn)(rows, str(tmp_path / "t"))
    assert_same_figures(port, mpl, str(tmp_path / "t"), str(tmp_path / "j"))


def test_global_panel_equals_jax(table, tmp_path, monkeypatch):
    """From the accumulators' device copies on the port's side, from the
    numpy arrays on JAX's."""
    _, gd = table
    assert set(gd["on_device"]) == {"lr_fft_sum", "hr_fft_sum", "grad_hr_sum",
                                    "glcm_sum"}
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    jeda.create_global_advanced_visualizations(gd, str(tmp_path / "j.png"))
    teda.create_global_advanced_visualizations(gd, str(tmp_path / "j.png"))
    assert_same_figures(port, mpl, str(tmp_path), str(tmp_path))


@pytest.mark.parametrize("name", ["p0.png", "p2.jpg"])
def test_scenario_figures_equal_jax(eda_ds, tmp_path, monkeypatch, name):
    """``save_visual_example`` (the difference map's JET bytes exactly;
    the dataset's own file type) and ``create_advanced_visualizations``
    (the maps computed by torch ops at the map tolerance, the GLCM and the
    saturation histograms exactly), on an aligned pair and with an LR of
    half the size that the figure itself enlarges."""
    lr, hr = _pair(eda_ds, name)
    small = lr[::2, ::2].contiguous()
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    for d, to in (("j", lambda t: t.numpy()), ("t", lambda t: t)):
        mod = jeda if d == "j" else teda
        out = str(tmp_path / d / "best_scenarios")
        mod.save_visual_example(to(lr), to(hr), os.path.join(out, name), 0.25)
        mod.save_visual_example(to(small), to(hr), os.path.join(out, "s_" + name),
                                None)
        mod.create_advanced_visualizations(to(lr), to(hr), os.path.join(
            out, "advanced_" + name))
    maps = {(2, i): MAP_TOL for i in (0, 1, 2, 4)}
    assert_same_figures(port, mpl, str(tmp_path / "t"), str(tmp_path / "j"),
                        maps=maps)


@pytest.mark.parametrize("seed", range(6))
def test_boxplot_stats_equal_matplotlib(seed):
    from matplotlib import cbook
    from tpusr_torch.viz.figure import boxplot_stats

    rng = np.random.default_rng(seed)
    samples = [rng.normal(size=int(rng.integers(1, 40))),
               np.concatenate([rng.normal(size=20), [15.0, -9.0]]),
               np.full(5, 2.0), np.zeros(0), rng.random(2)]
    labels = [f"s{i}" for i in range(len(samples))] if seed % 2 else None
    got = boxplot_stats(samples, labels=labels)
    want = cbook.boxplot_stats(samples, labels=labels)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w, f"seed {seed}")


@pytest.mark.parametrize("case", ["rows", "nan", "inf_and_constant",
                                  "all_nan_column", "one_row"])
def test_correlation_equals_pandas(table, case):
    rows, _ = table
    rows = [dict(r) for r in rows]
    if case == "nan":
        for i, r in enumerate(rows):
            if i % 2:
                r["psnr"] = math.nan
    elif case == "inf_and_constant":
        rows[0]["ssim"] = math.inf
        for r in rows:
            r["blocking_lr"] = 3.0
    elif case == "all_nan_column":
        for r in rows:
            r["edge_diff"] = math.nan
    elif case == "one_row":
        rows = rows[:1]
    num = _frame(rows).select_dtypes(include=[np.number]).dropna(axis=1,
                                                                 how="all")
    want = num.corr()
    cols, got = teda.correlation(rows)
    assert cols == list(want.columns)
    np.testing.assert_allclose(got, want.to_numpy(), rtol=1e-12, atol=0,
                               equal_nan=True)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want.to_numpy()))


@pytest.mark.parametrize("hi", [256, 200, 1])
def test_uint8_tensor_hist_equals_axes_hist(hi):
    import matplotlib.pyplot as plt
    from tpusr_torch.viz.figure import histogram

    x = np.random.default_rng(hi).integers(0, hi, 5000).astype(np.uint8) + (
        7 if hi == 1 else 0)
    for bins in (50, 7):
        counts, edges = histogram(torch.from_numpy(x), bins)
        _, ax = plt.subplots()
        m, e, _ = ax.hist(x, bins=bins)
        plt.close("all")
        np.testing.assert_array_equal(counts, m)
        np.testing.assert_array_equal(edges, e)


def test_run_eda_pipeline_writes_the_jax_pipelines_files(eda_ds, tmp_path,
                                                         monkeypatch):
    """The same file names under the same directories, each written at the
    JAX figure's size and dpi and decoding with cv2 and the port's
    decoders; the scenario dumps keep the dataset's file type. JAX's
    pipeline is handed the port's rows and accumulators (their parity is
    ``test_torch_eda.py``'s)."""
    jax_with_lpips(monkeypatch, None)
    with open(eda_ds / "imap.pkl", "rb") as f:
        imap = pickle.load(f)
    rows, gd = teda.collect_metrics(str(eda_ds / "LR"), str(eda_ds / "HR"),
                                    interp_map=imap, limit=3, device="cpu")
    monkeypatch.setattr(jeda, "collect_metrics", lambda *a, **k: (rows, gd))
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    jeda.run_eda_pipeline(str(eda_ds / "LR"), str(eda_ds / "HR"),
                          str(tmp_path / "j"), interp_map_path=str(
                              eda_ds / "imap.pkl"), limit=3)
    teda.run_eda_pipeline(str(eda_ds / "LR"), str(eda_ds / "HR"),
                          str(tmp_path / "t"), interp_map_path=str(
                              eda_ds / "imap.pkl"), limit=3, device="cpu")
    got = [(os.path.relpath(f, tmp_path / "t"), dpi) for _, f, dpi in port.saved]
    want = [(os.path.relpath(f, tmp_path / "j"), dpi) for _, f, dpi in mpl.saved]
    assert got == want
    assert len(got) == 11
    for fig, f, dpi in port.saved:
        assert_file(f, fig, dpi)
        (mf,) = [m for m, g, _ in mpl.saved
                 if os.path.relpath(g, tmp_path / "j") == os.path.relpath(
                     f, tmp_path / "t")]
        assert fig.figsize == tuple(mf.get_size_inches())


@pytest.mark.parametrize("method", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("size,out", [(64, 32), (96, 48), (607, 512), (45, 15),
                                      (60, 48), (100, 37)])
def test_uint8_shrink_equals_cv2(method, size, out):
    """OpenCV's fixed-point ``HResizeLinear``/``VResizeLinear`` and
    Lanczos4 with ``INTER_RESIZE_COEF_SCALE`` taps (IPP takes neither in
    this cv2; an exact x2 linear shrink goes to ``resizeAreaFast``, whose
    bytes are the same), on noise and on a smooth image."""
    flag = {"bilinear": cv2.INTER_LINEAR, "lanczos4": cv2.INTER_LANCZOS4}[method]
    noise = np.random.default_rng(size).integers(0, 256, (size, size, 3),
                                                  dtype=np.uint8)
    for img in (noise, _smooth(size)):
        got = ops.resize_u8(torch.from_numpy(img), (out, out), method).numpy()
        for ipp in (True, False):
            cv2.ipp.setUseIPP(ipp)
            try:
                want = cv2.resize(img, (out, out), interpolation=flag)
            finally:
                cv2.ipp.setUseIPP(True)
            np.testing.assert_array_equal(got, want)


def test_uint8_shrinks_of_any_shape_equal_cv2():
    """Random sides, channel counts and ratios, shrinking one side or both
    (and enlarging the other)."""
    rng = np.random.default_rng(11)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        c = int(rng.choice([1, 3, 4]))
        oh = int(rng.integers(1, h + 1))
        ow = int(rng.integers(1, 2 * w + 2))
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        for method, flag in (("bilinear", cv2.INTER_LINEAR),
                             ("lanczos4", cv2.INTER_LANCZOS4)):
            want = cv2.resize(img, (ow, oh), interpolation=flag).reshape(oh, ow, c)
            got = ops.resize_u8(torch.from_numpy(img), (oh, ow), method).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{(h, w, c)} -> "
                                          f"{(oh, ow)} {method}")
