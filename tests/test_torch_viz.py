"""The port's figures (``tpusr_torch/viz``) against the JAX package's
(``tpusr/viz``, matplotlib) on the CPU.

A recorder (``MplRecorder``) wraps matplotlib's ``Axes`` methods (and
``Axes3D``'s) that the JAX functions call, keeping each outermost call's
arguments and return, and replaces ``Figure.savefig`` by a no-op that
keeps the name and dpi. The same inputs, drawn from a numpy seed, go
through the JAX function and the port's; then, figure by figure and call
by call (``assert_same_figures``):

- the arguments, bound to the port method's signature: strings and labels
  exactly, numbers at rtol 1e-12 (device-computed maps at rtol 1e-5 /
  atol 1e-6, where a test says so);
- what the call computed: bar colours and centres, ``hist`` counts, edges
  and colour, ``boxplot_stats``, scatter and line colours, and each image's
  RGBA bytes equal to ``matplotlib.colormaps[name](Normalize(vmin, vmax)
  (data), bytes=True)`` of the port's data (RGB data as it is);
- the figure's size, suptitle, colorbars and file names with their dpi;
- each file the port wrote decodes with ``cv2.imread`` and the port's own
  decoders at figsize x dpi.

``classification_report_dict`` is held equal to JAX's exactly; the
committed tables (``tpusr_torch/viz/_tables.py``) equal what matplotlib and
cv2 give (``python tests/test_torch_viz.py --write-tables`` rewrites them).
"""

from __future__ import annotations

import base64
import inspect
import math
import os
import sys
import zlib

import numpy as np
import pytest
import torch

CMAP_NAMES = ("viridis", "magma", "inferno", "cividis", "Blues", "coolwarm",
              "gray")
FONT_PX = 40                     # pixels per em of the stored glyphs
FONT_CHARS = "".join(chr(c) for c in range(32, 127)) + "—"
TABLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpusr_torch", "viz", "_tables.py")
RTOL = 1e-12
MAP_TOL = {"rtol": 1e-5, "atol": 1e-6}     # maps computed by torch ops


# ------------------------------------------------------------ the tables
def _b64(a: np.ndarray) -> str:
    return base64.b64encode(zlib.compress(np.ascontiguousarray(a).tobytes(),
                                          9)).decode()


def colormap_luts() -> dict:
    import matplotlib
    out = {}
    for name in CMAP_NAMES:
        cm = matplotlib.colormaps[name]
        cm._init()
        out[name] = (cm._lut * 255).astype(np.uint8)      # (N + 3, 4)
    return out


def jet_bgr() -> np.ndarray:
    import cv2
    ramp = np.arange(256, dtype=np.uint8).reshape(1, 256)
    return cv2.applyColorMap(ramp, cv2.COLORMAP_JET)[0]  # (256, 3) BGR


def glyph_atlas():
    """(atlas (rows, width) uint8, baseline row, {char: (x0, cell width,
    advance)}) of DejaVu Sans at FONT_PX pixels per em, drawn by FreeType
    as matplotlib's Agg backend draws text."""
    from matplotlib import font_manager
    from matplotlib.ft2font import FT2Font, LoadFlags

    f = FT2Font(font_manager.findfont("DejaVu Sans"))
    f.set_size(FONT_PX, 72)
    asc = int(np.ceil(f.ascender / f.units_per_EM * FONT_PX)) + 2
    desc = int(np.ceil(-f.descender / f.units_per_EM * FONT_PX)) + 2
    rows = asc + desc
    cells, meta, x = [], {}, 0
    for ch in FONT_CHARS:
        g = f.load_char(ord(ch), flags=LoadFlags.DEFAULT)
        adv = g.linearHoriAdvance / 65536.0
        f.set_text(ch, 0.0, flags=LoadFlags.DEFAULT)
        f.draw_glyphs_to_bitmap(antialiased=True)
        im = np.asarray(f.get_image())
        d = int(round(f.get_descent() / 64))
        left = max(0, int(np.floor(g.horiBearingX / 64)))
        width = max(int(np.ceil(adv)), left + im.shape[1])
        cell = np.zeros((rows, width), np.uint8)
        if im.size:
            top = asc - (im.shape[0] - d)
            y0, y1 = max(top, 0), min(top + im.shape[0], rows)
            cell[y0:y1, left:left + im.shape[1]] = im[y0 - top:y1 - top]
        cells.append(cell)
        meta[ch] = (x, width, round(adv, 4))
        x += width
    return np.concatenate(cells, 1), asc, meta


def _wrap(s: str, indent: int = 4) -> str:
    parts = [s[i:i + 72] for i in range(0, len(s), 72)]
    pad = " " * indent
    return "(\n" + "".join(f'{pad}"{p}"\n' for p in parts) + pad[:-4] + ")"


def tables_source() -> str:
    """The text of ``tpusr_torch/viz/_tables.py``."""
    import matplotlib
    luts = colormap_luts()
    atlas, base, meta = glyph_atlas()
    cycle = matplotlib.rcParams["axes.prop_cycle"].by_key()["color"]
    lines = [
        '"""Data of the port\'s figures, written by ``python',
        'tests/test_torch_viz.py --write-tables`` (matplotlib 3.10.8, OpenCV',
        '5.0.0) and held against them by ``tests/test_torch_viz.py``:',
        '',
        '- ``LUTS``: matplotlib\'s colormaps as ``Colormap(x, bytes=True)``',
        '  reads them, ``(N + 3, 4)`` uint8 (N colours, then under, over and',
        '  bad), zlib and base64;',
        '- ``JET_BGR``: OpenCV\'s ``COLORMAP_JET`` (``applyColorMap`` of 0..255),',
        '  (256, 3) uint8 BGR;',
        '- ``CYCLE``: matplotlib\'s default colour cycle (C0-C9);',
        f'- ``GLYPHS``: DejaVu Sans at {FONT_PX} pixels per em, drawn by FreeType',
        '  as matplotlib\'s Agg backend draws it: one atlas of coverage (0-255),',
        '  ``GLYPH_ROWS`` rows, the baseline at row ``GLYPH_BASELINE``, and per',
        '  character its first column, cell width and advance in pixels.',
        '"""',
        '',
        f'GLYPH_PX = {FONT_PX}',
        f'GLYPH_ROWS = {atlas.shape[0]}',
        f'GLYPH_BASELINE = {base}',
        f'GLYPH_COLUMNS = {atlas.shape[1]}',
        'GLYPH_CELLS = {',
        *(f'    {ch!r}: ({x0}, {w}, {adv!r}),' for ch, (x0, w, adv) in meta.items()),
        '}',
        f'GLYPH_ATLAS = {_wrap(_b64(atlas))}',
        f'CYCLE = {tuple(cycle)!r}',
        f'JET_BGR = {_wrap(_b64(jet_bgr()))}',
        'LUTS = {',
        *(f'    {name!r}: ({lut.shape[0]}, {_wrap(_b64(lut), 8)}),'
          for name, lut in luts.items()),
        '}',
    ]
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ the recorder
AXES_METHODS = ("bar", "barh", "imshow", "hist", "boxplot", "scatter", "plot",
                "text", "annotate", "axhline", "set_title", "set_xlabel",
                "set_ylabel", "set_xticks", "set_yticks", "set_ylim",
                "tick_params", "legend", "axis")
AXES3D_METHODS = ("scatter", "text", "set_zlabel", "view_init", "set_xlabel",
                  "set_ylabel", "set_title")


class MplRecorder:
    """Keeps the outermost matplotlib calls the figure functions make:
    ``calls[fig]`` is a list of (Axes, name, args, kwargs, return), and
    ``saved`` the (fig, file name, dpi) of each ``savefig``, which writes
    nothing."""

    def __init__(self, mp):
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib.axes import Axes
        from matplotlib.figure import Figure
        from mpl_toolkits.mplot3d.axes3d import Axes3D

        self.calls, self.saved, self.depth = {}, [], 0
        for name in AXES_METHODS:
            mp.setattr(Axes, name, self._wrap(getattr(Axes, name), name))
        for name in AXES3D_METHODS:       # those Axes3D defines itself
            if name in Axes3D.__dict__:
                mp.setattr(Axes3D, name, self._wrap(Axes3D.__dict__[name], name))
        for name in ("colorbar", "suptitle"):
            mp.setattr(Figure, name, self._wrap(getattr(Figure, name), name,
                                                figure_level=True))
        # calls an Axes makes on itself while it is built are not the
        # figure functions'
        from matplotlib.axes._base import _AxesBase
        for cls in (_AxesBase, Axes3D):
            mp.setattr(cls, "__init__", self._quiet(cls.__init__))
        for name in ("tight_layout", "subplots", "add_subplot"):
            mp.setattr(Figure, name, self._quiet(getattr(Figure, name)))

        def savefig(fig, fname, dpi=None, **kw):
            self.saved.append((fig, str(fname), float(dpi or fig.dpi)))
        mp.setattr(Figure, "savefig", savefig)

    def _quiet(self, init):
        def run(obj, *a, **kw):
            self.depth += 1
            try:
                return init(obj, *a, **kw)
            finally:
                self.depth -= 1
        return run

    def _wrap(self, fn, name, figure_level=False):
        rec = self

        def run(obj, *args, **kwargs):
            outer = rec.depth == 0
            rec.depth += 1
            try:
                ret = fn(obj, *args, **kwargs)
            finally:
                rec.depth -= 1
            if outer:
                fig = obj if figure_level else obj.figure
                rec.calls.setdefault(fig, []).append(
                    (None if figure_level else obj, name, args, kwargs, ret))
            return ret
        run.__signature__ = inspect.signature(fn)
        return run


class PortRecorder:
    """The port's figures in the order they were saved, with name and dpi;
    the files are written."""

    def __init__(self, mp):
        from tpusr_torch.viz.figure import Figure
        self.saved = []
        real = Figure.savefig

        def savefig(fig, fname, dpi=None, **kw):
            self.saved.append((fig, str(fname), float(dpi or fig.dpi)))
            return real(fig, fname, dpi=dpi, **kw)
        mp.setattr(Figure, "savefig", savefig)


# ------------------------------------------------------------ comparisons
def _plain(v, axes_index):
    """Arguments as comparable values: arrays for tensors and pandas
    columns, lists for tuples and ranges, indices for Axes and images."""
    import matplotlib.image
    from matplotlib.axes import Axes as MAxes
    from tpusr_torch.viz.figure import Axes as PAxes, Image as PImage

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (MAxes, PAxes)):
        return ("axes", axes_index(v))
    if isinstance(v, matplotlib.image.AxesImage):
        return ("image", axes_index(v.axes))
    if isinstance(v, PImage):
        return ("image", axes_index(v.axes))
    if hasattr(v, "to_numpy"):
        return np.asarray(v.to_numpy())
    if isinstance(v, range):
        return list(v)
    if isinstance(v, (list, tuple)):
        return [_plain(x, axes_index) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x, axes_index) for k, x in v.items()}
    if isinstance(v, np.generic):
        return v.item()
    return v


def assert_same(got, want, where, rtol=RTOL, atol=0.0):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want, (where, got, want)
    elif want is None or got is None:
        assert got is None and want is None, (where, got, want)
    elif isinstance(want, tuple) and want and want[0] in ("axes", "image"):
        assert got == want, (where, got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}", rtol, atol)
    elif (isinstance(want, list) and any(isinstance(x, (str, list, dict, np.ndarray))
                                          for x in want)):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]", rtol, atol)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        if w.dtype.kind in "fiub" and g.dtype.kind in "fiub":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=where)
        else:
            assert g.tolist() == w.tolist(), (where, got, want)


def _bound(method, args, kwargs) -> dict:
    sig = inspect.signature(method)
    ba = sig.bind(None, *args, **kwargs)
    ba.apply_defaults()
    d = dict(ba.arguments)
    d.pop(next(iter(sig.parameters)))            # self
    for k, p in sig.parameters.items():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            d.update(d.pop(k))
    return d


def mpl_rgba(data, cmap, vmin, vmax) -> np.ndarray:
    """What matplotlib maps an image to: a colormap's bytes of the masked
    data for 2-D data, the RGB bytes with alpha 255 for uint8 RGB."""
    import matplotlib
    from matplotlib.colors import Normalize

    data = np.asarray(data)
    if data.ndim == 2:
        return matplotlib.colormaps[cmap or "viridis"](
            Normalize(vmin, vmax)(np.ma.masked_invalid(data)), bytes=True)
    if data.dtype != np.uint8:
        data = (np.clip(data, 0, 1) * 255).astype(np.uint8)
    return np.concatenate([data, np.full(data.shape[:2] + (1,), 255, np.uint8)],
                          2) if data.shape[2] == 3 else data


def _mpl_out(name, ret, bound) -> dict:
    """What the port records as ``out``, read from matplotlib's return."""
    from matplotlib import cbook
    from matplotlib.colors import to_rgba

    if name == "bar":
        return {"x": [p.get_x() + p.get_width() / 2 for p in ret.patches],
                "colors": [tuple(p.get_facecolor()) for p in ret.patches]}
    if name == "barh":
        return {"y": [p.get_y() + p.get_height() / 2 for p in ret.patches],
                "colors": [tuple(p.get_facecolor()) for p in ret.patches]}
    if name == "hist":
        return {"counts": ret[0], "edges": ret[1],
                "color": tuple(ret[2].patches[0].get_facecolor())}
    if name == "boxplot":
        x = [np.asarray(_plain(v, None)) for v in bound["X"]]
        return {"stats": cbook.boxplot_stats(x, labels=bound["tick_labels"])}
    if name == "scatter":
        return {"color": tuple(ret.get_facecolors()[0])}
    if name == "plot":
        return {"color": to_rgba(ret[0].get_color())}
    return {}


def assert_same_figures(port: PortRecorder, mpl: MplRecorder, root_port,
                        root_mpl, maps: dict | None = None):
    """The port's saved figures against matplotlib's, in order. ``maps``:
    {(figure index, axes index): tolerance} for device-computed images."""
    from tpusr_torch.viz.figure import Axes3D as PAxes3D, Figure as PFigure

    maps = maps or {}
    assert len(port.saved) == len(mpl.saved), (
        [os.path.relpath(f, root_port) for _, f, _ in port.saved],
        [os.path.relpath(f, root_mpl) for _, f, _ in mpl.saved])
    for k, ((pf, pname, pdpi), (mf, mname, mdpi)) in enumerate(
            zip(port.saved, mpl.saved)):
        where = os.path.relpath(mname, root_mpl)
        assert os.path.relpath(pname, root_port) == where
        assert pdpi == mdpi, where
        assert pf.figsize == tuple(mf.get_size_inches()), where
        m_axes = [a for a in mf.axes]

        def m_index(a):
            return m_axes.index(a)

        def p_index(a):
            return pf.axes.index(a)

        m_calls = mpl.calls.get(mf, [])
        # figure-level calls
        want = [(n, _plain(_bound(getattr(type(mf), n), a, kw), m_index))
                for ax, n, a, kw, _ in m_calls if ax is None]
        got = [(c.name, _plain(_bound(getattr(PFigure, c.name), c.args,
                                      c.kwargs), p_index))
               for c in pf.calls if c.name in ("colorbar", "suptitle")]
        want = [(n, {key: v for key, v in d.items()
                     if key in ("mappable", "ax", "shrink", "t")})
                for n, d in want]
        assert [n for n, _ in got] == [n for n, _ in want], where
        for (n, g), (_, w) in zip(got, want):
            assert_same(g, w, f"{where} {n}")
        for i, pax in enumerate(pf.axes):
            mcalls = [c for c in m_calls if c[0] is m_axes[i]]
            assert [c.name for c in pax.calls] == [c[1] for c in mcalls], (
                where, i, [c.name for c in pax.calls], [c[1] for c in mcalls])
            for pc, (_, name, a, kw, ret) in zip(pax.calls, mcalls):
                at = f"{where} axes {i} {name}"
                meth = getattr(type(pax), name)
                wb = _bound(meth, a, kw)
                gb = _bound(meth, pc.args, pc.kwargs)
                tol = (maps.get((k, i), {}) if name == "imshow" else {})
                assert_same(_plain(gb, p_index), _plain(wb, m_index), at, **tol)
                want_out = _mpl_out(name, ret, wb)
                for key, w in want_out.items():
                    assert_same(_plain(pc.out[key], p_index), _plain(w, m_index),
                                f"{at} {key}")
                if name == "imshow":
                    data = _plain(gb["X"], p_index)
                    np.testing.assert_array_equal(
                        pc.out["rgba"].cpu().numpy(),
                        mpl_rgba(data, gb["cmap"], gb["vmin"], gb["vmax"]),
                        err_msg=at)
            assert isinstance(pax, PAxes3D) == (
                getattr(m_axes[i], "name", "") == "3d"), where
        assert_file(pname, pf, pdpi)


def assert_file(path, fig, dpi):
    """The written file decodes with cv2 and the port's own decoder at
    figsize x dpi."""
    import cv2
    from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
    from tpusr_torch.pipeline.png import decode_png_u8

    want = (round(fig.figsize[1] * dpi), round(fig.figsize[0] * dpi), 3)
    img = cv2.imread(path)
    assert img is not None and img.shape == want, (path, None if img is None
                                                    else img.shape, want)
    with open(path, "rb") as f:
        body = f.read()
    dec = (decode_jpeg_u8 if path.lower().endswith((".jpg", ".jpeg"))
           else decode_png_u8)(body)
    assert dec.shape == want, path
    if not path.lower().endswith((".jpg", ".jpeg")):
        np.testing.assert_array_equal(dec, img[..., ::-1])


# ------------------------------------------------------------ inputs
ALGS = ["bilinear", "bicubic", "area", "lanczos", "ibp", "nlm", "egi", "freq"]
COLORS = {"bilinear": "#4c72b0", "bicubic": "#55a868", "area": "#c44e52",
          "lanczos": "#8172b2", "ibp": "#ccb974", "nlm": "#64b5cd",
          "egi": "#8c8c8c"}                  # freq falls back to the default
SUMMARY_KEYS = ("time_mean", "time_max", "time_jitter", "time_var",
                "memory_mean", "memory_max", "memory_var", "psnr_mean",
                "psnr_max", "psnr_var", "psnr_ci_low", "psnr_ci_high",
                "ssim_mean", "ssim_max", "ssim_var", "ssim_ci_low",
                "ssim_ci_high", "mae_mean", "mae_max", "rmse_mean", "rmse_max",
                "grad_mse_mean", "epi_mean", "hf_ratio_mean", "kl_luma_mean",
                "kl_color_mean")


def metric_summary(seed: int) -> dict:
    """A summary of the schema of ``build_metrics_summary`` for the eight
    algorithms, with a NaN CI, a missing key and an algorithm left out."""
    rng = np.random.default_rng(seed)
    out = {}
    for a in ALGS[:-1]:
        s = {k: float(rng.random() * 10.0 ** rng.integers(-3, 6)) for k in SUMMARY_KEYS}
        s["psnr_mean"] = float(20 + 10 * rng.random())
        s["psnr_ci_low"], s["psnr_ci_high"] = s["psnr_mean"] - 1, s["psnr_mean"] + 1.5
        s["ssim_mean"] = float(rng.random())
        s["ssim_ci_low"], s["ssim_ci_high"] = s["ssim_mean"] - 0.05, s["ssim_mean"] + 0.02
        out[a] = s
    out["nlm"]["ssim_ci_low"] = math.nan
    del out["egi"]["kl_color_mean"]
    return out


def _vis(seed, hw=24):
    rng = np.random.default_rng(seed)
    hr = rng.integers(0, 256, (hw, hw, 3), np.uint8)

    def near(scale):
        return np.clip(hr.astype(np.float64) + rng.normal(scale=scale,
                       size=hr.shape), 0, 255).astype(np.uint8)
    lr = hr[::2, ::2].copy()
    vis = (hr, lr, near(5), near(8), near(12), near(3))
    ibp = (None, None, near(6).astype(np.float32))            # 0..255 floats
    nlm = (None, near(9)[..., 0])                              # gray uint8
    egi = (None, None, near(4).astype(np.float32) / 255.0)     # 0..1 floats
    freq = (None, near(10))
    return vis, ibp, nlm, egi, freq


# ------------------------------------------------------------ the tests
def test_tables_equal_matplotlib_and_cv2():
    """The committed colormaps, JET, colour cycle and glyphs are what
    matplotlib 3.10.8, FreeType through matplotlib and cv2 give."""
    with open(TABLES) as f:
        assert f.read() == tables_source()


@pytest.mark.parametrize("name", CMAP_NAMES)
def test_colormap_equals_matplotlib(name):
    import matplotlib
    from matplotlib.colors import Normalize
    from tpusr_torch.viz import colormaps

    rng = np.random.default_rng(len(name))
    cases = [rng.random((9, 11)), rng.random((9, 11)).astype(np.float32),
             rng.integers(0, 256, (7, 7)).astype(np.uint8),
             rng.integers(-5, 50, (6, 6)), np.full((3, 4), 2.5),
             np.array([[np.nan, 0.2, -0.3], [np.inf, 0.7, 1.0]]),
             rng.normal(size=(8, 8)) * 3,
             np.linspace(0, 1, 1025).reshape(25, 41)]
    cm = colormaps.get_cmap(name)
    for x in cases:
        for lim in ((None, None), (0, 1), (-1, 1), (None, 1)):
            if lim[0] is None and lim[1] is not None and np.nanmin(
                    np.where(np.isfinite(x), x, np.nan)) > lim[1]:
                for fn in (lambda: Normalize(*lim)(np.ma.masked_invalid(x)),
                           lambda: cm.rgba_numpy(x, *lim),
                           lambda: cm.rgba_tensor(torch.from_numpy(x), *lim)):
                    with pytest.raises(ValueError, match="minvalue"):
                        fn()
                continue
            want = matplotlib.colormaps[name](
                Normalize(*lim)(np.ma.masked_invalid(x)), bytes=True)
            np.testing.assert_array_equal(cm.rgba_numpy(x, *lim), want)
            np.testing.assert_array_equal(
                cm.rgba_tensor(torch.from_numpy(x), *lim).numpy(), want)


def test_jet_equals_cv2_apply_color_map():
    import cv2
    from tpusr_torch.viz.colormaps import apply_color_map_jet

    g = np.random.default_rng(0).integers(0, 256, (33, 17), np.uint8)
    np.testing.assert_array_equal(
        apply_color_map_jet(torch.from_numpy(g)).numpy(),
        cv2.applyColorMap(g, cv2.COLORMAP_JET))


def test_colour_names_equal_matplotlib():
    from matplotlib.colors import to_rgba as mpl_rgba_of
    from tpusr_torch.viz.colormaps import to_rgba

    for c in ("#4c72b0", "#888", "#888888", "#c44e52", "k", "white", "black",
              "C0", "C3", "C9", "r", "g", "b", "c", "m", "y", "w", "#11223344",
              (0.1, 0.2, 0.3)):
        assert to_rgba(c) == mpl_rgba_of(c), c
        assert to_rgba(c, 0.6) == mpl_rgba_of(c, 0.6), c
    with pytest.raises(ValueError, match="colour"):
        to_rgba("tab:blue")


def test_font_draws_every_title_character_and_boxes_the_rest():
    from tpusr_torch.viz import font

    font.MISSING.clear()
    for rot in (0, 30, 45, 60, 90):
        cov, base = font.render("SSIM map — lanczos (acc=0.875) [x_1]", 20, rot)
        assert 0 < cov.max() <= 1.0 and cov.mean() > 0.01
        if rot == 90:             # turned a quarter: tall and narrow
            assert cov.shape[0] > 5 * cov.shape[1]
    assert not font.MISSING
    box, _ = font.render("☃", 20)
    blank, _ = font.render(" ", 20)
    assert box.max() > 0.5 and blank.max() == 0.0
    assert font.MISSING == {"☃": 1}
    two, _ = font.render("Difference map\nLPIPS: 0.1234", 20)
    one, _ = font.render("Difference map", 20)
    assert two.shape[0] > 1.9 * 20 and two.shape[1] == one.shape[1]


@pytest.mark.parametrize("case", ["random", "absent_class", "one_class",
                                  "perfect", "num_classes"])
def test_classification_report_dict_equals_jax(case):
    from tpusr.viz.dl_viz import classification_report_dict as want_fn
    from tpusr_torch.viz import classification_report_dict

    rng = np.random.default_rng(7)
    y = rng.integers(0, 3, 40)
    p = rng.integers(0, 3, 40)
    kw = {}
    if case == "absent_class":      # class 3: no support; class 2: no prediction
        p = np.where(p == 2, 0, p)
        kw = {"num_classes": 4}
    elif case == "one_class":
        y, p = np.zeros(9, int), np.zeros(9, int)
    elif case == "perfect":
        p = y.copy()
    elif case == "num_classes":
        kw = {"num_classes": 5}
    got = classification_report_dict(y, p, **kw)
    want = want_fn(y, p, **kw)
    assert got == want
    assert [type(v) for v in got["per_class"][0].values()] == [
        type(v) for v in want["per_class"][0].values()]


def _classic_calls(viz, out, summary, vis_args, ranking):
    viz.plot_time_memory_panels(summary, ALGS, COLORS, "Classical SR Profiling:"
                                " Time & Memory", os.path.join(
                                    out, "time_memory_summary.png"))
    viz.plot_psnr_ssim_panels(summary, ALGS, COLORS, "Classical SR: PSNR / SSIM",
                              os.path.join(out, "psnr_ssim_summary.png"))
    viz.plot_speed_quality_tradeoff_3d(summary, ALGS, COLORS, results_dir=out)
    viz.plot_error_metrics_grid(summary, ALGS, COLORS, results_dir=out)
    viz.plot_edge_metrics_grid(summary, ALGS, COLORS, results_dir=out)
    viz.plot_frequency_distribution_metrics_grid(summary, ALGS, COLORS,
                                                 results_dir=out)
    viz.plot_and_save_super_resolution_example(*vis_args, out)
    return viz.show_algorithm_ranking(summary, **ranking, results_dir=out,
                                      colors_map=COLORS)


def test_classic_figures_equal_jax(tmp_path, monkeypatch):
    """The classic command's seven figures (its metric lists and weights
    for the ranking) and the SR example grid (uint8 RGB, 0-255 floats, 0-1
    floats, gray)."""
    import tpusr.viz as jviz
    import tpusr_torch.viz as tviz
    from tpusr.classic.harness import RANKING_WEIGHTS

    summary = metric_summary(1)
    kw = {"maximize": ["psnr_mean", "ssim_mean"],
          "minimize": ["time_mean", "memory_mean", "mae_mean", "rmse_mean",
                       "grad_mse_mean", "kl_luma_mean", "kl_color_mean"],
          "weights": RANKING_WEIGHTS}
    vis_args = _vis(3)
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    want = _classic_calls(jviz, str(tmp_path / "j"), summary, vis_args, kw)
    got = _classic_calls(tviz, str(tmp_path / "t"), summary, vis_args, kw)
    assert got == want
    assert_same_figures(port, mpl, str(tmp_path / "t"), str(tmp_path / "j"))


def test_ranking_with_its_default_metrics_equals_jax(tmp_path, monkeypatch):
    """``show_algorithm_ranking`` with ``rank_algorithms``' own metric sets
    and equal weights."""
    import tpusr.viz as jviz
    import tpusr_torch.viz as tviz

    summary = metric_summary(4)
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    want = jviz.show_algorithm_ranking(summary, results_dir=str(tmp_path / "j"),
                                       dpi=40)
    got = tviz.show_algorithm_ranking(summary, results_dir=str(tmp_path / "t"),
                                      dpi=40)
    assert got == want
    assert_same_figures(port, mpl, str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("shapes", ["equal", "one_differs"])
def test_ssim_maps_equal_jax(tmp_path, monkeypatch, shapes):
    """The SSIM maps, computed by the port's ``_filter2_valid`` on the CPU
    device, against JAX's ``jnp`` maps at rtol 1e-5 / atol 1e-6; their
    colours are viridis of the port's maps, byte for byte."""
    import tpusr.viz as jviz
    import tpusr_torch.viz as tviz

    vis, ibp, nlm, egi, freq = _vis(5, hw=20)
    if shapes == "equal":
        vis = (vis[0], vis[0][::2, ::2], *vis[2:])
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    jviz.plot_and_save_ssim_similarity_maps(vis, ibp, nlm, egi, freq,
                                            str(tmp_path / "j"))
    tviz.plot_and_save_ssim_similarity_maps(vis, ibp, nlm, egi, freq,
                                            str(tmp_path / "t"), device="cpu")
    assert_same_figures(port, mpl, str(tmp_path / "t"), str(tmp_path / "j"),
                        maps={(0, i): MAP_TOL for i in range(8)})


def _pipeline_like(seed, n=12, methods=("bilinear", "bicubic", "edsr")):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    preds = [np.where(rng.random(n) < 0.7, y, 1 - y) for _ in methods]
    preds[-1][:] = 0                              # a method that never says 1
    confs = [rng.random(n) * 0.5 + 0.5 for _ in methods]
    metrics = {m: {"train_loss": rng.random(), "val_loss": rng.random(),
                   "eval_psnr": 20 + rng.random(), "train_epoch_time_sec": 3.2,
                   "inference_time_sec": rng.random(),
                   "inference_mem_peak_mb": 100 * rng.random()}
               for m in methods[1:]}
    return y, list(methods), preds, confs, metrics


def _dl_calls(viz, subplots, out, y, names, preds, confs, metrics, images):
    reports = viz.plot_classification_reports_panel(
        y, names, preds, class_names=["low_z_offset", "high_z_offset"],
        save_dir=out)
    stats = viz.plot_confidence_panel(y, names, preds, confs, save_dir=out)
    fig, axes = subplots(2, 3, figsize=(15, 9), squeeze=False)
    for ax in axes.ravel()[len(names):]:
        ax.axis("off")
    for ax, n, p in zip(axes.ravel(), names, preds):
        cm = np.zeros((2, 2), np.int64)
        for t, q in zip(y, p):
            cm[t, q] += 1
        viz.plot_confusion(ax, cm, ["low", "high"], n)
    fig.savefig(os.path.join(out, "confusion_matrices.png"), dpi=150)
    viz.plot_sr_metrics(names, metrics, save_dir=out)
    viz.plot_sr_time(names, metrics, save_dir=out)
    viz.plot_sr_memory(names, metrics, save_dir=out)
    viz.plot_4x3(images, titles=[f"img {i}" for i in range(len(images))],
                 save_dir=out)
    return reports, stats


def test_dl_figures_equal_jax(tmp_path, monkeypatch):
    """The pipeline command's figures, the confusion grid through
    ``plot_confusion`` on the port's Axes, and the 4x3 image grid (uint8
    RGB, float RGB beyond [0, 1], gray)."""
    import matplotlib.pyplot as plt
    import tpusr.viz as jviz
    import tpusr_torch.viz as tviz
    from tpusr_torch.viz.figure import subplots

    y, names, preds, confs, metrics = _pipeline_like(2)
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (10, 12, 3), np.uint8),
              rng.normal(0.5, 0.4, (10, 12, 3)), rng.random((10, 12)),
              rng.integers(0, 256, (6, 6), np.uint8)]
    port, mpl = PortRecorder(monkeypatch), MplRecorder(monkeypatch)
    want = _dl_calls(jviz, plt.subplots, str(tmp_path / "j"), y, names, preds,
                     confs, metrics, images)
    got = _dl_calls(tviz, subplots, str(tmp_path / "t"), y, names, preds,
                    confs, metrics, images)
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        assert_same(g, w, "confidence stats")
    assert_same_figures(port, mpl, str(tmp_path / "t"), str(tmp_path / "j"))


def test_image_panels_are_the_mapped_data_resampled(tmp_path):
    """In the written PNG each image panel is its data through the colormap
    (on the host), nearest-resampled into the recorded panel box; a NaN
    pixel is white."""
    from tpusr_torch.pipeline.png import decode_png_u8
    from tpusr_torch.viz import colormaps
    from tpusr_torch.viz.figure import subplots
    from tpusr_torch.viz.render import nearest_index

    rng = np.random.default_rng(0)
    data = rng.normal(size=(13, 29))
    data[3, 4] = np.nan
    fig, (a, b) = subplots(1, 2, figsize=(8, 3))
    im = a.imshow(torch.from_numpy(data), cmap="magma", aspect="auto")
    b.imshow(rng.integers(0, 256, (5, 7, 3), np.uint8))
    fig.colorbar(im, ax=a)
    path = str(tmp_path / "f.png")
    fig.savefig(path, dpi=80)
    with open(path, "rb") as f:
        img = decode_png_u8(f.read())
    for call, cmap in ((a.calls[0], "magma"), (b.calls[0], None)):
        y0, x0, h, w = call.out["panel"]
        src = (colormaps.get_cmap(cmap).rgba_numpy(data) if cmap else
               np.asarray(call.out["rgba"]))
        want = src[nearest_index(src.shape[0], h)][:, nearest_index(src.shape[1], w)]
        a_ = want[..., 3:].astype(np.float64) / 255
        rgb = np.rint(want[..., :3] * a_ + 255 * (1 - a_)).astype(np.uint8)
        np.testing.assert_array_equal(img[y0:y0 + h, x0:x0 + w], rgb)
    assert (img == 255).all(-1).mean() < 0.9


def test_savefig_writes_png_and_quality_75_jpeg(tmp_path):
    import cv2
    from tpusr_torch.pipeline.jpeg_encode import encode_jpeg_u8
    from tpusr_torch.viz.figure import subplots

    fig, ax = subplots(figsize=(3, 2))
    ax.bar(["a", "b"], [1.0, 2.0])
    ax.set_title("t")
    for name in ("f.png", "f.jpg", "f.JPEG"):
        canvas = fig.savefig(str(tmp_path / name), dpi=50)
        assert_file(str(tmp_path / name), fig, 50)
    with open(tmp_path / "f.jpg", "rb") as f:
        assert f.read() == encode_jpeg_u8(canvas, quality=75)
    png = cv2.imread(str(tmp_path / "f.png"))[..., ::-1]
    np.testing.assert_array_equal(png, canvas)


def test_subplots_shapes_like_matplotlib():
    import matplotlib.pyplot as plt
    from tpusr_torch.viz.figure import Axes, subplots

    for args, kw in (((1, 1), {}), ((1, 3), {}), ((3, 1), {}), ((2, 2), {}),
                     ((1, 2), {"squeeze": False}), ((1, 1), {"squeeze": False})):
        _, want = plt.subplots(*args, **kw)
        _, got = subplots(*args, **kw)
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.shape == want.shape
        else:
            assert isinstance(got, Axes)
        plt.close("all")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-tables"]:
        with open(TABLES, "w") as f:
            f.write(tables_source())
        print(f"wrote {TABLES}")
