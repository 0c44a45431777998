"""The port's figure writer: the subset of matplotlib's ``Figure``/``Axes``
API that the JAX package's figure functions call, and nothing more.

Each ``Axes`` call is kept as a ``Call`` (name, positional and keyword
arguments as given, and ``out``: what the call computed as matplotlib
computes it):

- ``bar``/``barh``: the bars' centres and RGBA face colours (``color``, or
  the next colour of the Axes' patch cycle, C0-C9);
- ``hist``: ``np.histogram``'s counts and edges over the data's own range
  (NaN left out), and the face colour (``color``, or the next colour of the
  line cycle) with ``alpha``; a uint8 tensor is counted on its device;
- ``boxplot``: ``boxplot_stats`` (``matplotlib.cbook.boxplot_stats`` at
  ``whis=1.5``: linear percentiles, whiskers at the furthest datum within
  1.5 IQR, fliers);
- ``imshow``: the RGBA bytes of the image (a colormap's, on the data's
  device, see ``colormaps``; RGB data as matplotlib converts it);
- ``scatter``/``plot``: the face or line colour.

``Figure.savefig`` draws from these records: a canvas of figsize x dpi
pixels on white (the size before matplotlib's ``bbox_inches="tight"``
crop), a grid layout with room for titles, ticks and labels, colorbars,
legends, the 3-D panel projected at its ``view_init``, text in the port's
font (``font.py``). Images are resampled into their panel by nearest
neighbour as a gather on the data's device, and the panels of one figure
come to the host in one copy; everything else is drawn on the host in
numpy. The file is a PNG (``pipeline/png.py``) or, for a ``.jpg``/
``.jpeg`` name, a baseline JPEG at quality 75 (``pipeline/jpeg_encode.py``,
matplotlib's default quality).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpusr_torch.viz import colormaps, font

DEFAULT_DPI = 100
FONT_PT = 10.0              # rcParams font.size
TITLE_PT = 12.0             # axes.titlesize "large"
MARKER_S = 36.0             # lines.markersize ** 2
LINE_PT = 1.5               # lines.linewidth
SPINE_PT = 0.8              # axes.linewidth
BAR_WIDTH = 0.8
MARGIN = 0.05               # axes.xmargin / ymargin
BOXPLOT_WHIS = 1.5


@dataclass
class Call:
    """One call on an Axes or Figure: its name, arguments as given, and what
    it computed (``out``)."""
    name: str
    args: tuple
    kwargs: dict
    out: dict = field(default_factory=dict)


@dataclass
class Bar:
    """A drawn bar, with the accessors the figure functions read."""
    x: float
    y: float
    width: float
    height: float

    def get_x(self) -> float:
        return self.x

    def get_width(self) -> float:
        return self.width


def _numbers(v) -> np.ndarray:
    """A 1-D float64 array of ``v`` (list, tuple, range, array, tensor)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64).reshape(-1)


def boxplot_stats(X, labels=None, whis: float = BOXPLOT_WHIS) -> list[dict]:
    """``matplotlib.cbook.boxplot_stats(X, whis, labels=labels)`` for a
    list of 1-D samples."""
    out = []
    labels = [None] * len(X) if labels is None else list(labels)
    if len(labels) != len(X):
        raise ValueError("Dimensions of labels and X must be compatible")
    for x, label in zip(X, labels):
        stats = {} if label is None else {"label": label}
        x = np.asarray(x).ravel()
        if len(x) == 0:
            out.append({**stats, "fliers": np.array([]), **dict.fromkeys(
                ("mean", "med", "q1", "q3", "iqr", "cilo", "cihi", "whislo",
                 "whishi"), np.nan)})
            continue
        stats["mean"] = np.mean(x)
        q1, med, q3 = np.percentile(x, [25, 50, 75])
        stats["iqr"] = q3 - q1
        n = len(x)
        stats["cilo"] = med - 1.57 * stats["iqr"] / np.sqrt(n)
        stats["cihi"] = med + 1.57 * stats["iqr"] / np.sqrt(n)
        loval = q1 - whis * stats["iqr"]
        hival = q3 + whis * stats["iqr"]
        hi = x[x <= hival]
        stats["whishi"] = q3 if len(hi) == 0 or np.max(hi) < q3 else np.max(hi)
        lo = x[x >= loval]
        stats["whislo"] = q1 if len(lo) == 0 or np.min(lo) > q1 else np.min(lo)
        stats["fliers"] = np.concatenate([x[x < stats["whislo"]],
                                          x[x > stats["whishi"]]])
        stats["q1"], stats["med"], stats["q3"] = q1, med, q3
        out.append(stats)
    return out


def histogram(x, bins: int):
    """(counts, edges) as ``Axes.hist`` computes them for one dataset:
    ``np.histogram`` over (nanmin, nanmax). A uint8 tensor is counted on its
    device (256 bins) and folded into the edges on the host."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.uint8:
        c = torch.bincount(x.reshape(-1).long(), minlength=256).cpu().numpy()
        vals = np.flatnonzero(c)
        if vals.size == 0:
            m, e = np.histogram(np.zeros(0), bins)
        else:
            rng = (np.uint8(vals.min()), np.uint8(vals.max()))
            m, e = np.histogram(vals, bins, range=rng, weights=c[vals])
        return np.array(m, float), np.array(e, float)
    x = np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                   else x)
    x = x.reshape(-1)
    rng = None
    if len(x):
        with np.errstate(invalid="ignore"):
            lo, hi = np.nanmin(x), np.nanmax(x)
        if lo <= hi:
            rng = (lo, hi)
    m, e = np.histogram(x, bins, range=rng)
    return np.array(m, float), np.array(e, float)


class Axes:
    """A 2-D panel: the calls the JAX figure functions make on it."""

    projection = None

    def __init__(self, fig: Figure, cell):
        self.figure = fig
        self.cell = cell                 # (row0, row1, col0, col1) in the grid
        self.calls: list[Call] = []
        self._patch_cycle = 0            # bar, scatter
        self._line_cycle = 0             # plot, hist
        self._xcats: dict[str, int] = {}
        self._ycats: dict[str, int] = {}

    def _call(self, name, args, kwargs, **out) -> Call:
        c = Call(name, args, kwargs, out)
        self.calls.append(c)
        return c

    def _next(self, cycle: str) -> tuple:
        n = getattr(self, cycle)
        setattr(self, cycle, n + 1)
        return colormaps.to_rgba(colormaps.CYCLE[n % len(colormaps.CYCLE)])

    def _positions(self, v, cats: dict) -> np.ndarray:
        """Numbers, or categories mapped to 0, 1, ... in order of first
        appearance (matplotlib's string category axis)."""
        v = list(v) if not isinstance(v, (np.ndarray, torch.Tensor)) else v
        if len(v) and isinstance(v[0], str):
            for s in v:
                cats.setdefault(s, len(cats))
            return np.array([cats[s] for s in v], np.float64)
        return _numbers(v)

    def _colors(self, color, n, alpha=None, cycle="_patch_cycle") -> list:
        if color is None:
            return [self._next(cycle)[:3] + (1.0 if alpha is None else alpha,)] * n
        if isinstance(color, (list, tuple)) and color and not isinstance(
                color[0], (int, float)):
            return [colormaps.to_rgba(c, alpha) for c in color]
        return [colormaps.to_rgba(color, alpha)] * n

    # ---------------------------------------------------------- the calls
    def bar(self, x, height, width=BAR_WIDTH, *, yerr=None, capsize=None,
            color=None, label=None):
        pos = self._positions(x, self._xcats)
        h = _numbers(height)
        if yerr is not None and (np.asarray(yerr, np.float64) < 0).any():
            raise ValueError("'yerr' must not contain negative values")
        colors = self._colors(color, len(pos))
        w = np.broadcast_to(_numbers(width), pos.shape)
        bars = [Bar(float(p - wi / 2), 0.0, float(wi), float(hv))
                for p, wi, hv in zip(pos, w, h)]
        self._call("bar", (x, height, width),
                   {"yerr": yerr, "capsize": capsize, "color": color,
                    "label": label},
                   x=[b.x + b.width / 2 for b in bars], colors=colors)
        return bars

    def barh(self, y, width, *, color=None):
        pos = self._positions(y, self._ycats)
        colors = self._colors(color, len(pos))
        # the centres as matplotlib's bars give them: y - h/2 + h/2
        self._call("barh", (y, width), {"color": color},
                   y=[float(p - BAR_WIDTH / 2 + BAR_WIDTH / 2) for p in pos],
                   colors=colors)

    def imshow(self, X, cmap=None, vmin=None, vmax=None, aspect=None):
        t = X if isinstance(X, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(X))
        if t.dim() == 2:
            cm = colormaps.get_cmap(cmap or "viridis")
            rgba = cm.rgba_tensor(t, vmin, vmax)
        elif t.dim() == 3 and t.shape[2] in (3, 4):
            if t.dtype == torch.uint8:
                rgb = t
            else:          # float RGB: clipped to [0, 1], then x * 255 truncated
                rgb = (t.double().clamp(0, 1) * 255).to(torch.uint8)
            rgba = (rgb if rgb.shape[2] == 4 else torch.cat(
                [rgb, torch.full_like(rgb[..., :1], 255)], 2))
        else:
            raise ValueError(f"imshow takes (H, W) or (H, W, 3|4) data, not "
                             f"{tuple(t.shape)}")
        c = self._call("imshow", (X,), {"cmap": cmap, "vmin": vmin,
                                        "vmax": vmax, "aspect": aspect},
                       rgba=rgba)
        return Image(self, c, t)

    def hist(self, x, bins=10, *, alpha=None, label=None, color=None):
        counts, edges = histogram(x, bins)
        (col,) = self._colors(color, 1, alpha, cycle="_line_cycle")
        self._call("hist", (x,), {"bins": bins, "alpha": alpha,
                                  "label": label, "color": color},
                   counts=counts, edges=edges, color=col)
        return counts, edges

    def boxplot(self, X, *, tick_labels=None):
        stats = boxplot_stats(X, labels=tick_labels)
        self._call("boxplot", (X,), {"tick_labels": tick_labels}, stats=stats)
        return stats

    def scatter(self, x, y, s=None, *, alpha=None, color=None, label=None):
        (col,) = self._colors(color, 1, alpha)
        self._call("scatter", (x, y), {"s": s, "alpha": alpha, "color": color,
                                       "label": label}, color=col)

    def plot(self, x, y, *, label=None, color=None):
        (col,) = self._colors(color, 1, cycle="_line_cycle")
        self._call("plot", (x, y), {"label": label, "color": color}, color=col)

    def text(self, x, y, s, **kwargs):
        self._call("text", (x, y, s), kwargs)

    def annotate(self, text, xy, **kwargs):
        self._call("annotate", (text, xy), kwargs)

    def axhline(self, y=0, **kwargs):
        self._call("axhline", (y,), kwargs)

    def set_title(self, label, **kwargs):
        self._call("set_title", (label,), kwargs)

    def set_xlabel(self, label, **kwargs):
        self._call("set_xlabel", (label,), kwargs)

    def set_ylabel(self, label, **kwargs):
        self._call("set_ylabel", (label,), kwargs)

    def set_xticks(self, ticks, labels=None, **kwargs):
        self._call("set_xticks", (ticks, labels), kwargs)

    def set_yticks(self, ticks, labels=None, **kwargs):
        self._call("set_yticks", (ticks, labels), kwargs)

    def set_ylim(self, bottom=None, top=None):
        self._call("set_ylim", (bottom, top), {})

    def tick_params(self, axis="both", **kwargs):
        self._call("tick_params", (), {"axis": axis, **kwargs})

    def legend(self, **kwargs):
        self._call("legend", (), kwargs)

    def axis(self, arg):
        if arg != "off":
            raise ValueError(f"axis({arg!r}): the figures only turn axes off")
        self._call("axis", (arg,), {})

    # ----------------------------------------------------------- queries
    def is_off(self) -> bool:
        return any(c.name == "axis" for c in self.calls)

    def last(self, name: str) -> Call | None:
        for c in reversed(self.calls):
            if c.name == name:
                return c
        return None


class Axes3D(Axes):
    """The 3-D panel of ``add_subplot(111, projection="3d")``."""

    projection = "3d"

    def __init__(self, fig, cell):
        super().__init__(fig, cell)
        self.elev, self.azim = 30.0, -60.0

    def scatter(self, xs, ys, zs, s=None, *, color=None, label=None):
        (col,) = self._colors(color, 1)
        self._call("scatter", (xs, ys, zs), {"s": s, "color": color,
                                             "label": label}, color=col)

    def text(self, x, y, z, s, **kwargs):
        self._call("text", (x, y, z, s), kwargs)

    def set_zlabel(self, label, **kwargs):
        self._call("set_zlabel", (label,), kwargs)

    def view_init(self, elev=None, azim=None):
        self.elev, self.azim = float(elev), float(azim)
        self._call("view_init", (elev, azim), {})


class Image:
    """What ``imshow`` returns: the mappable a colorbar reads."""

    def __init__(self, ax: Axes, call: Call, data: torch.Tensor):
        self.axes, self.call, self.data = ax, call, data

    def limits(self) -> tuple[float, float]:
        """The colour scale's (vmin, vmax): given, or the finite data's."""
        kw = self.call.kwargs
        d = self.data.double()
        fin = d[torch.isfinite(d)]
        lo = kw["vmin"] if kw["vmin"] is not None else (
            float(fin.min()) if fin.numel() else 0.0)
        hi = kw["vmax"] if kw["vmax"] is not None else (
            float(fin.max()) if fin.numel() else 0.0)
        return float(lo), float(hi)


class Figure:
    def __init__(self, figsize=(6.4, 4.8), dpi=DEFAULT_DPI, nrows=1, ncols=1,
                 width_ratios=None, height_ratios=None):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self.grid = (nrows, ncols, list(width_ratios or [1.0] * ncols),
                     list(height_ratios or [1.0] * nrows))
        self.axes: list[Axes] = []
        self.calls: list[Call] = []
        self.saved: list[tuple[str, float, int]] = []   # (file, dpi, bytes)
        self.boxes: list[tuple[int, int, int, int]] = []  # drawn frames

    def add_subplot(self, *args, projection=None):
        if args not in ((), (111,), (1, 1, 1)):
            raise ValueError(f"add_subplot{args}: the figures add one panel")
        ax = (Axes3D if projection == "3d" else Axes)(self, (0, 1, 0, 1))
        self.axes.append(ax)
        return ax

    def suptitle(self, t, **kwargs):
        self.calls.append(Call("suptitle", (t,), kwargs))

    def colorbar(self, mappable: Image, ax=None, shrink=1.0):
        self.calls.append(Call("colorbar", (mappable,),
                               {"ax": ax, "shrink": shrink}))

    def tight_layout(self):
        self.calls.append(Call("tight_layout", (), {}))

    def savefig(self, fname, dpi=None, **_ignored):
        """Draw the figure at ``dpi`` (default: the figure's) into ``fname``
        (PNG, or JPEG at quality 75 for a .jpg/.jpeg name). Returns the
        (H, W, 3) uint8 canvas; ``boxes`` then holds each Axes' frame
        (x0, y0, x1, y1) in its pixels."""
        from tpusr_torch.viz import render

        canvas = render.draw(self, float(dpi or self.dpi))
        name = str(fname)
        if name.lower().endswith((".jpg", ".jpeg")):
            from tpusr_torch.pipeline.jpeg_encode import encode_jpeg_u8
            body = encode_jpeg_u8(canvas, quality=75)
        else:
            from tpusr_torch.pipeline.png import encode_png_u8
            body = encode_png_u8(canvas)
        with open(name, "wb") as f:
            f.write(body)
        self.saved.append((name, float(dpi or self.dpi), len(body)))
        return canvas


def figure(figsize=None, dpi=None) -> Figure:
    return Figure(figsize or (6.4, 4.8), dpi or DEFAULT_DPI)


def subplots(nrows=1, ncols=1, *, figsize=None, dpi=None, squeeze=True,
             gridspec_kw=None):
    """(Figure, Axes or an object array of Axes), shaped as matplotlib's
    ``plt.subplots`` shapes it."""
    gk = gridspec_kw or {}
    fig = Figure(figsize or (6.4, 4.8), dpi or DEFAULT_DPI, nrows, ncols,
                 gk.get("width_ratios"), gk.get("height_ratios"))
    axes = np.empty((nrows, ncols), object)
    for r in range(nrows):
        for c in range(ncols):
            axes[r, c] = Axes(fig, (r, r + 1, c, c + 1))
            fig.axes.append(axes[r, c])
    if squeeze:
        if axes.size == 1:
            return fig, axes[0, 0]
        if nrows == 1 or ncols == 1:
            return fig, axes.ravel()
    return fig, axes
