"""``Figure.savefig``'s drawing: the layout of the grid, then the image
panels (resampled on their data's device and brought to the host in one
copy), then every other artist and the text, on an (H, W, 3) float canvas
of white, returned as uint8.

Sizes follow matplotlib's defaults in points (1/72 inch), scaled by the
dpi. The layout is the port's own: each grid cell keeps room for its
title, tick labels and axis labels, as ``tight_layout`` would; it does not
reproduce matplotlib's pixels."""

from __future__ import annotations

import math

import numpy as np
import torch

from tpusr_torch.viz import colormaps, font
from tpusr_torch.viz.figure import (BAR_WIDTH, FONT_PT, LINE_PT, MARGIN,
                                    MARKER_S, SPINE_PT, TITLE_PT, Axes,
                                    Figure, Image, _numbers)

GREY = (0.5, 0.5, 0.5, 1.0)
BLACK = (0.0, 0.0, 0.0, 1.0)


def nearest_index(n_src: int, n_dst: int) -> np.ndarray:
    """Source index of each of ``n_dst`` samples of a nearest-neighbour
    resample of ``n_src`` samples."""
    return np.minimum(((np.arange(n_dst) + 0.5) * n_src / n_dst).astype(
        np.int64), n_src - 1)


class Canvas:
    def __init__(self, h: int, w: int, dpi: float):
        self.a = np.ones((h, w, 3), np.float32)
        self.pt = dpi / 72.0                    # pixels per point

    def _blend(self, y0, x0, cov, rgba):
        h, w = cov.shape
        H, W = self.a.shape[:2]
        ya, xa = max(0, y0), max(0, x0)
        yb, xb = min(H, y0 + h), min(W, x0 + w)
        if ya >= yb or xa >= xb:
            return
        c = cov[ya - y0:yb - y0, xa - x0:xb - x0, None] * rgba[3]
        reg = self.a[ya:yb, xa:xb]
        reg *= 1.0 - c
        reg += c * np.asarray(rgba[:3], np.float32)

    def rect(self, x0, y0, x1, y1, rgba):
        xa, xb = sorted((x0, x1))
        ya, yb = sorted((y0, y1))
        xa, ya = int(round(xa)), int(round(ya))
        xb, yb = max(int(round(xb)), xa + 1), max(int(round(yb)), ya + 1)
        self._blend(ya, xa, np.ones((yb - ya, xb - xa), np.float32), rgba)

    def line(self, x0, y0, x1, y1, width_pt, rgba, dash=None):
        r = max(0.5, width_pt * self.pt / 2)
        xa, xb = int(math.floor(min(x0, x1) - r - 1)), int(math.ceil(max(x0, x1) + r + 1))
        ya, yb = int(math.floor(min(y0, y1) - r - 1)), int(math.ceil(max(y0, y1) + r + 1))
        yy, xx = np.mgrid[ya:yb, xa:xb].astype(np.float32)
        dx, dy = x1 - x0, y1 - y0
        ln2 = dx * dx + dy * dy
        t = (np.clip(((xx - x0) * dx + (yy - y0) * dy) / ln2, 0, 1)
             if ln2 > 0 else np.zeros_like(xx))
        d = np.hypot(xx - (x0 + t * dx), yy - (y0 + t * dy))
        cov = np.clip(r + 0.5 - d, 0, 1)
        if dash is not None:
            on, off = (v * width_pt * self.pt for v in dash)
            cov = cov * ((t * math.sqrt(ln2)) % (on + off) < on)
        self._blend(ya, xa, cov.astype(np.float32), rgba)

    def disc(self, cx, cy, radius, rgba, outline=False):
        r = max(radius, 0.75)
        xa, ya = int(math.floor(cx - r - 1)), int(math.floor(cy - r - 1))
        yy, xx = np.mgrid[ya:int(math.ceil(cy + r + 2)),
                          xa:int(math.ceil(cx + r + 2))].astype(np.float32)
        d = np.hypot(xx - cx, yy - cy)
        cov = np.clip(r + 0.5 - d, 0, 1)
        if outline:
            cov = cov * np.clip(d - (r - 1.5 * self.pt) + 0.5, 0, 1)
        self._blend(ya, xa, cov.astype(np.float32), rgba)

    def text(self, s, x, y, size_pt, rgba=BLACK, ha="center", va="baseline",
             rotation=0.0):
        """Draw ``s``; returns its (x0, y0, x1, y1) box."""
        s = str(s)
        if not s:
            return (x, y, x, y)
        cov, base = font.render(s, size_pt * self.pt, rotation,
                                ha if ha in ("left", "right") else "center")
        h, w = cov.shape
        x0 = x - {"left": 0.0, "right": w}.get(ha, w / 2)
        if va == "baseline" and not rotation % 360:
            y0 = y - base
        else:
            y0 = y - {"top": 0.0, "bottom": h}.get(va, h / 2)
        x0, y0 = int(round(x0)), int(round(y0))
        self._blend(y0, x0, cov, rgba)
        return (x0, y0, x0 + w, y0 + h)

    def text_size(self, s, size_pt, rotation=0.0) -> tuple[int, int]:
        cov, _ = font.render(str(s), size_pt * self.pt, rotation)
        return cov.shape


# --------------------------------------------------------------- scales
def nice_ticks(lo: float, hi: float, n: int = 6) -> np.ndarray:
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
        return np.array([lo]) if np.isfinite(lo) else np.zeros(0)
    raw = (hi - lo) / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    ticks = np.arange(first, hi + step * 1e-9, step)
    return np.round(ticks / step) * step


def tick_label(v: float, ticks: np.ndarray) -> str:
    span = np.max(np.abs(ticks)) if len(ticks) else abs(v)
    if span >= 1e5 or (0 < span < 1e-3):
        return f"{v:.3g}"
    step = np.min(np.diff(ticks)) if len(ticks) > 1 else 1.0
    dec = max(0, -int(math.floor(math.log10(step))) + (1 if step / 10 **
              math.floor(math.log10(step)) == 2.5 else 0)) if step > 0 else 0
    return f"{v:.{dec}f}"


def _finite(a) -> np.ndarray:
    a = _numbers(a)
    return a[np.isfinite(a)]


def data_limits(ax: Axes):
    """(xlo, xhi, ylo, yhi), the limits matplotlib's autoscale would give,
    near enough to draw: data extents, 5% margins, bars and histograms kept
    on their zero edge, images at their pixel edges (y downwards)."""
    xs, ys = [], []
    sticky_y, sticky_x = set(), set()
    image = None
    for c in ax.calls:
        if c.name == "bar":
            x, w = np.asarray(c.out["x"]), _numbers(c.args[2])
            h = _numbers(c.args[1])
            err = c.kwargs.get("yerr")
            e = np.zeros((2, len(h))) if err is None else np.broadcast_to(
                np.asarray(err, np.float64), (2, len(h)))
            xs += [x - w / 2, x + w / 2]
            ys += [h, h + e[1], h - e[0], [0.0]]
            sticky_y.add(0.0)
        elif c.name == "barh":
            y = np.asarray(c.out["y"])
            ys += [y - BAR_WIDTH / 2, y + BAR_WIDTH / 2]
            xs += [_numbers(c.args[1]), [0.0]]
            sticky_x.add(0.0)
        elif c.name == "hist":
            xs.append(c.out["edges"])
            ys += [c.out["counts"], [0.0]]
            sticky_y.add(0.0)
        elif c.name == "boxplot":
            for s in c.out["stats"]:
                ys += [[s["whislo"], s["whishi"]], s["fliers"]]
            n = len(c.out["stats"])
            xs.append([0.5, n + 0.5])
            sticky_x.update((0.5, n + 0.5))
        elif c.name in ("scatter", "plot"):
            xs.append(c.args[0])
            ys.append(c.args[1])
        elif c.name == "axhline":
            ys.append([c.args[0]])
        elif c.name == "imshow":
            image = c.out["rgba"].shape
    if image is not None:
        return -0.5, image[1] - 0.5, image[0] - 0.5, -0.5
    lims = []
    for vals, sticky in ((xs, sticky_x), (ys, sticky_y)):
        v = np.concatenate([_finite(a) for a in vals]) if vals else np.zeros(0)
        if v.size == 0:
            lims += [0.0, 1.0]
            continue
        lo, hi = float(v.min()), float(v.max())
        if hi == lo:
            d = abs(lo) * 0.05 or 0.05
            lims += [lo - d, hi + d]
            continue
        m = (hi - lo) * MARGIN
        lims += [lo if lo in sticky else lo - m, hi if hi in sticky else hi + m]
    xlo, xhi, ylo, yhi = lims
    ylim = ax.last("set_ylim")
    if ylim is not None:
        ylo = ylo if ylim.args[0] is None else float(ylim.args[0])
        yhi = yhi if ylim.args[1] is None else float(ylim.args[1])
    return xlo, xhi, ylo, yhi


def ticks_of(ax: Axes, axis: str, lo: float, hi: float):
    """[(position, label)], rotation, ha and font size of an axis' ticks."""
    call = ax.last(f"set_{axis}ticks")
    cats = ax._xcats if axis == "x" else ax._ycats
    rot, ha, size = 0.0, None, FONT_PT
    for c in ax.calls:
        if c.name == "tick_params" and c.kwargs.get("axis") in (axis, "both"):
            rot = float(c.kwargs.get("rotation", rot))
    if call is not None:
        pos = _numbers(call.args[0])
        labels = call.args[1]
        rot = float(call.kwargs.get("rotation", rot))
        ha = call.kwargs.get("ha")
        size = float(call.kwargs.get("fontsize", size))
        if labels is None:
            labels = [tick_label(p, pos) for p in pos]
        return list(zip(pos, [str(s) for s in labels])), rot, ha, size
    if cats:
        return [(float(i), s) for s, i in cats.items()], rot, ha, size
    box = ax.last("boxplot")
    if axis == "x" and box is not None:
        n = len(box.out["stats"])
        labels = box.kwargs.get("tick_labels") or [str(i) for i in range(1, n + 1)]
        return [(float(i + 1), str(s)) for i, s in enumerate(labels)], rot, ha, size
    a, b = sorted((lo, hi))
    pos = nice_ticks(a, b)
    return [(p, tick_label(p, pos)) for p in pos], rot, ha, size


# --------------------------------------------------------------- layout
class Box:
    """An Axes' frame in pixels and its data limits."""

    def __init__(self, x0, y0, x1, y1, lims):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.xlo, self.xhi, self.ylo, self.yhi = lims

    def X(self, x):
        return self.x0 + (np.asarray(x, np.float64) - self.xlo) / (
            self.xhi - self.xlo) * (self.x1 - self.x0)

    def Y(self, y):
        return self.y1 - (np.asarray(y, np.float64) - self.ylo) / (
            self.yhi - self.ylo) * (self.y1 - self.y0)


def _colorbars(fig: Figure):
    """{id(Axes): colorbar call} for one-axes colorbars, and the calls that
    span several axes."""
    single, spanning = {}, []
    for c in fig.calls:
        if c.name != "colorbar":
            continue
        ax = c.kwargs.get("ax")
        if isinstance(ax, (list, tuple)) and len(ax) > 1:
            spanning.append(c)
        else:
            ax = ax[0] if isinstance(ax, (list, tuple)) else ax
            single[id(ax if ax is not None else c.args[0].axes)] = c
    return single, spanning


def _margins(cv: Canvas, ax: Axes, lims):
    """(left, bottom, top) room in pixels for ticks, labels and title."""
    pt = cv.pt
    title = ax.last("set_title")
    top = (float(title.kwargs.get("fontsize", TITLE_PT)) * pt * 1.9
           if title is not None else 4 * pt)
    if ax.is_off() or ax.projection == "3d":
        return 4 * pt, 4 * pt, top
    xt, xrot, _, xsize = ticks_of(ax, "x", lims[0], lims[1])
    yt, _, _, ysize = ticks_of(ax, "y", lims[2], lims[3])
    bottom = max([cv.text_size(s, xsize, xrot)[0] for _, s in xt] + [0]) + 6 * pt
    left = max([cv.text_size(s, ysize)[1] for _, s in yt] + [0]) + 7 * pt
    if ax.last("set_xlabel") is not None:
        bottom += FONT_PT * pt * 1.8
    if ax.last("set_ylabel") is not None:
        left += FONT_PT * pt * 1.8
    return left, bottom, top


def layout(cv: Canvas, fig: Figure) -> dict:
    """{id(Axes): Box}, plus the colorbars' rectangles."""
    H, W = cv.a.shape[:2]
    pt = cv.pt
    nrows, ncols, wr, hr = fig.grid
    top = 6 * pt
    sup = next((c for c in fig.calls if c.name == "suptitle"), None)
    if sup is not None:
        top += TITLE_PT * pt * 2.0
    x0, y0, x1, y1 = 6 * pt, top, W - 6 * pt, H - 6 * pt
    single, spanning = _colorbars(fig)
    bars = []
    for c in spanning:
        strip = 0.07 * (x1 - x0)
        bars.append((c, (x1 - strip * 0.55, y0, x1 - strip * 0.35, y1)))
        x1 -= strip
    cw = np.cumsum([0.0] + wr) / sum(wr) * (x1 - x0) + x0
    ch = np.cumsum([0.0] + hr) / sum(hr) * (y1 - y0) + y0
    boxes = {}
    for ax in fig.axes:
        r0, r1, c0, c1 = ax.cell
        cx0, cx1, cy0, cy1 = cw[c0], cw[c1], ch[r0], ch[r1]
        lims = data_limits(ax)
        left, bottom, ttl = _margins(cv, ax, lims)
        bx0, by0 = cx0 + left, cy0 + ttl
        bx1, by1 = cx1 - 0.03 * (cx1 - cx0), cy1 - bottom
        cb = single.get(id(ax))
        if cb is not None:
            strip = 0.16 * (bx1 - bx0)
            bars.append((cb, (bx1 - strip * 0.7, by0, bx1 - strip * 0.45, by1)))
            bx1 -= strip
        img = ax.last("imshow")
        if img is not None and img.kwargs.get("aspect") != "auto":
            h, w = img.out["rgba"].shape[:2]
            s = min((bx1 - bx0) / w, (by1 - by0) / h)
            cx, cy = (bx0 + bx1) / 2, (by0 + by1) / 2
            bx0, bx1 = cx - w * s / 2, cx + w * s / 2
            by0, by1 = cy - h * s / 2, cy + h * s / 2
        box = Box(int(round(bx0)), int(round(by0)), max(int(round(bx1)),
                  int(round(bx0)) + 2), max(int(round(by1)),
                  int(round(by0)) + 2), lims)
        boxes[id(ax)] = box
    for i, (c, rect) in enumerate(bars):
        shrink = float(c.kwargs.get("shrink", 1.0))
        _, ya, _, yb = rect
        mid, half = (ya + yb) / 2, (yb - ya) * shrink / 2
        bars[i] = (c, (rect[0], mid - half, rect[2], mid + half))
    return {"boxes": boxes, "colorbars": bars, "suptitle": sup, "top": top}


# ---------------------------------------------------------------- panels
def image_panels(fig: Figure, boxes: dict) -> None:
    """Each image resampled into its box on its device, the figure's panels
    brought to the host in one copy and kept in ``out["panel_rgba"]`` with
    the box in ``out["panel"]`` (y0, x0, h, w)."""
    pending = []
    for ax in fig.axes:
        for c in ax.calls:
            if c.name != "imshow":
                continue
            b = boxes[id(ax)]
            ph, pw = b.y1 - b.y0, b.x1 - b.x0
            src = c.out["rgba"]
            ri = torch.from_numpy(nearest_index(src.shape[0], ph)).to(src.device)
            ci = torch.from_numpy(nearest_index(src.shape[1], pw)).to(src.device)
            pending.append((c, (b.y0, b.x0, ph, pw), src[ri][:, ci]))
    if not pending:
        return
    for dev in {p.device for _, _, p in pending}:
        here = [(c, rect, p) for c, rect, p in pending if p.device == dev]
        flat = torch.cat([p.reshape(-1) for _, _, p in here]).cpu().numpy()
        at = 0
        for c, rect, p in here:
            n = p.numel()
            c.out["panel"] = rect
            c.out["panel_rgba"] = flat[at:at + n].reshape(rect[2], rect[3], 4)
            at += n


def _blit(cv: Canvas, y0, x0, rgba):
    a = rgba[..., 3:4].astype(np.float32) / 255.0
    reg = cv.a[y0:y0 + rgba.shape[0], x0:x0 + rgba.shape[1]]
    reg *= 1.0 - a
    reg += a * rgba[..., :3].astype(np.float32) / 255.0


# ----------------------------------------------------------------- draw
def _frame(cv: Canvas, b: Box):
    t = max(1, int(round(SPINE_PT * cv.pt)))
    cv.rect(b.x0 - t, b.y0 - t, b.x1 + t, b.y0, BLACK)
    cv.rect(b.x0 - t, b.y1, b.x1 + t, b.y1 + t, BLACK)
    cv.rect(b.x0 - t, b.y0, b.x0, b.y1, BLACK)
    cv.rect(b.x1, b.y0, b.x1 + t, b.y1, BLACK)


def _ticks(cv: Canvas, ax: Axes, b: Box):
    pt = cv.pt
    t = max(1, int(round(SPINE_PT * pt)))
    for axis in ("x", "y"):
        lo, hi = (b.xlo, b.xhi) if axis == "x" else (b.ylo, b.yhi)
        ticks, rot, ha, size = ticks_of(ax, axis, lo, hi)
        a, z = sorted((lo, hi))
        for p, s in ticks:
            if not (a - 1e-9 <= p <= z + 1e-9):
                continue
            if axis == "x":
                x = float(b.X(p))
                cv.rect(x - t / 2, b.y1 + t, x + t / 2, b.y1 + t + 3.5 * pt, BLACK)
                cv.text(s, x, b.y1 + 5.5 * pt, size, ha=ha or (
                    "center" if not rot else "right" if rot % 90 else "center"),
                    va="top", rotation=rot)
            else:
                y = float(b.Y(p))
                cv.rect(b.x0 - t - 3.5 * pt, y - t / 2, b.x0 - t, y + t / 2, BLACK)
                cv.text(s, b.x0 - 5.5 * pt, y, size, ha="right", va="center")


def _labels(cv: Canvas, ax: Axes, b: Box, left: float, bottom: float):
    pt = cv.pt
    xl, yl = ax.last("set_xlabel"), ax.last("set_ylabel")
    if xl is not None:
        cv.text(xl.args[0], (b.x0 + b.x1) / 2, b.y1 + bottom, FONT_PT,
                va="bottom")
    if yl is not None:
        cv.text(yl.args[0], b.x0 - left + 2 * pt, (b.y0 + b.y1) / 2, FONT_PT,
                ha="left", va="center", rotation=90)


def _bars(cv: Canvas, ax: Axes, b: Box):
    pt = cv.pt
    for c in ax.calls:
        if c.name == "bar":
            w = np.broadcast_to(_numbers(c.args[2]), (len(c.out["x"]),))
            h = _numbers(c.args[1])
            for x, wi, hv, col in zip(c.out["x"], w, h, c.out["colors"]):
                if np.isfinite(hv):
                    cv.rect(b.X(x - wi / 2), b.Y(0.0), b.X(x + wi / 2), b.Y(hv), col)
            err = c.kwargs.get("yerr")
            if err is not None:
                e = np.broadcast_to(np.asarray(err, np.float64), (2, len(h)))
                cap = float(c.kwargs.get("capsize") or 0) * pt
                for x, hv, lo, hi in zip(c.out["x"], h, e[0], e[1]):
                    if not np.isfinite(hv):
                        continue
                    X = float(b.X(x))
                    ya, yb = float(b.Y(hv - lo)), float(b.Y(hv + hi))
                    cv.line(X, ya, X, yb, LINE_PT, BLACK)
                    for yy in (ya, yb):
                        if cap:
                            cv.line(X - cap, yy, X + cap, yy, LINE_PT, BLACK)
        elif c.name == "barh":
            wv = _numbers(c.args[1])
            for y, wi, col in zip(c.out["y"], wv, c.out["colors"]):
                if np.isfinite(wi):
                    cv.rect(b.X(0.0), b.Y(y - BAR_WIDTH / 2), b.X(wi),
                            b.Y(y + BAR_WIDTH / 2), col)
        elif c.name == "hist":
            e, n = c.out["edges"], c.out["counts"]
            for i in range(len(n)):
                if n[i] > 0:
                    cv.rect(b.X(e[i]), b.Y(0.0), b.X(e[i + 1]), b.Y(n[i]),
                            c.out["color"])
        elif c.name == "boxplot":
            orange = colormaps.to_rgba("C1")
            for i, s in enumerate(c.out["stats"], start=1):
                if not np.isfinite(s["med"]):
                    continue
                half = 0.25
                X0, X1, Xc = float(b.X(i - half)), float(b.X(i + half)), float(b.X(i))
                q1, q3 = float(b.Y(s["q1"])), float(b.Y(s["q3"]))
                for (xa, ya, xb, yb) in ((X0, q1, X1, q1), (X0, q3, X1, q3),
                                         (X0, q1, X0, q3), (X1, q1, X1, q3)):
                    cv.line(xa, ya, xb, yb, 1.0, BLACK)
                m = float(b.Y(s["med"]))
                cv.line(X0, m, X1, m, 1.0, orange)
                for q, wsk in ((q1, s["whislo"]), (q3, s["whishi"])):
                    wy = float(b.Y(wsk))
                    cv.line(Xc, q, Xc, wy, 1.0, BLACK)
                    cv.line(Xc - (Xc - X0) / 2, wy, Xc + (Xc - X0) / 2, wy, 1.0,
                            BLACK)
                for f in s["fliers"]:
                    cv.disc(Xc, float(b.Y(f)), 3 * pt, BLACK, outline=True)


def _lines(cv: Canvas, ax: Axes, b: Box):
    pt = cv.pt
    for c in ax.calls:
        if c.name == "scatter":
            s = float(c.kwargs.get("s") or MARKER_S)
            r = math.sqrt(s) / 2 * pt
            x, y = _numbers(c.args[0]), _numbers(c.args[1])
            for xi, yi in zip(x, y):
                if np.isfinite(xi) and np.isfinite(yi):
                    cv.disc(float(b.X(xi)), float(b.Y(yi)), r, c.out["color"])
        elif c.name == "plot":
            x, y = _numbers(c.args[0]), _numbers(c.args[1])
            X, Y = b.X(x), b.Y(y)
            for i in range(len(x) - 1):
                if np.isfinite([X[i], Y[i], X[i + 1], Y[i + 1]]).all():
                    cv.line(X[i], Y[i], X[i + 1], Y[i + 1], LINE_PT, c.out["color"])
        elif c.name == "axhline":
            kw = c.kwargs
            y = float(b.Y(c.args[0]))
            dash = (3.7, 1.6) if kw.get("ls", kw.get("linestyle")) == "--" else None
            cv.line(b.x0, y, b.x1, y, float(kw.get("lw", kw.get("linewidth",
                    LINE_PT))), colormaps.to_rgba(kw.get("color", "C0")), dash)


def _texts(cv: Canvas, ax: Axes, b: Box):
    for c in ax.calls:
        if c.name == "text" and ax.projection != "3d":
            x, y, s = c.args
            kw = c.kwargs
            cv.text(s, float(b.X(x)), float(b.Y(y)), float(kw.get("fontsize",
                    FONT_PT)), colormaps.to_rgba(kw.get("color", "black")),
                    kw.get("ha", "left"), kw.get("va", "baseline"))
        elif c.name == "annotate":
            s, (x, y) = c.args
            kw = c.kwargs
            cv.text(s, float(b.X(x)), float(b.Y(y)), float(kw.get("fontsize",
                    FONT_PT)), BLACK, kw.get("ha", "left"),
                    kw.get("va", "baseline"))


def _legend(cv: Canvas, ax: Axes, b: Box):
    call = ax.last("legend")
    if call is None:
        return
    pt = cv.pt
    size = float(call.kwargs.get("fontsize", FONT_PT))
    entries = []
    for c in ax.calls:
        label = c.kwargs.get("label")
        if label is None or str(label).startswith("_"):
            continue
        if c.name == "bar":
            entries.append(("patch", c.out["colors"][0], label))
        elif c.name == "hist":
            entries.append(("patch", c.out["color"], label))
        elif c.name == "plot":
            entries.append(("line", c.out["color"], label))
        elif c.name == "axhline":
            entries.append(("dash", colormaps.to_rgba(c.kwargs.get("color", "C0")),
                            label))
        elif c.name == "scatter":
            entries.append(("dot", c.out["color"], label))
    if not entries:
        return
    row = size * pt * 1.4
    width = max(cv.text_size(lab, size)[1] for _, _, lab in entries) + 3 * size * pt
    x1, y0 = b.x1 - 4 * pt, b.y0 + 4 * pt
    x0 = x1 - width
    cv.rect(x0, y0, x1, y0 + row * len(entries) + 4 * pt, (1, 1, 1, 0.8))
    for i, (kind, col, label) in enumerate(entries):
        y = y0 + 2 * pt + row * (i + 0.5)
        hx0, hx1 = x0 + 4 * pt, x0 + 2.2 * size * pt
        if kind == "patch":
            cv.rect(hx0, y - row * 0.3, hx1, y + row * 0.3, col)
        elif kind == "dot":
            cv.disc((hx0 + hx1) / 2, y, row * 0.25, col)
        else:
            cv.line(hx0, y, hx1, y, LINE_PT, col, (3.7, 1.6) if kind == "dash"
                    else None)
        cv.text(label, hx1 + 3 * pt, y, size, ha="left", va="center")


def _colorbar(cv: Canvas, call, rect):
    mappable: Image = call.args[0]
    img = mappable.call
    cm = colormaps.get_cmap(img.kwargs.get("cmap") or "viridis")
    lo, hi = mappable.limits()
    x0, y0, x1, y1 = (int(round(v)) for v in rect)
    h = max(1, y1 - y0)
    f = 1.0 - (np.arange(h) + 0.5) / h
    idx = np.clip((f * cm.N).astype(np.int64), 0, cm.N - 1)
    col = cm.lut[idx][:, None, :].repeat(max(1, x1 - x0), 1)
    _blit(cv, y0, x0, col)
    _frame(cv, Box(x0, y0, max(x1, x0 + 1), y1, (0, 1, lo, hi)))
    if hi > lo:
        b = Box(x0, y0, x1, y1, (0, 1, lo, hi))
        ticks = nice_ticks(lo, hi)
        for p in ticks:
            y = float(b.Y(p))
            cv.rect(x1, y - 0.5, x1 + 3.5 * cv.pt, y + 0.5, BLACK)
            cv.text(tick_label(p, ticks), x1 + 5 * cv.pt, y, FONT_PT,
                    ha="left", va="center")


def _axes3d(cv: Canvas, ax: Axes, b: Box):
    """The 3-D panel: the scatter's points in a unit cube turned to the
    view (elevation, azimuth), drawn far to near, with the cube's edges and
    the axis labels."""
    pts, cols, sizes, texts = [], [], [], []
    for c in ax.calls:
        if c.name == "scatter":
            p = np.stack([_numbers(v) for v in c.args], 1)
            pts.append(p)
            cols += [c.out["color"]] * len(p)
            sizes += [float(c.kwargs.get("s") or MARKER_S)] * len(p)
        elif c.name == "text":
            texts.append(c)
    allp = np.concatenate(pts) if pts else np.zeros((0, 3))
    allp = allp[np.isfinite(allp).all(1)] if len(allp) else allp
    lo = allp.min(0) if len(allp) else np.zeros(3)
    hi = allp.max(0) if len(allp) else np.ones(3)
    span = np.where(hi > lo, hi - lo, 1.0)
    lo, hi = lo - MARGIN * span, hi + MARGIN * span
    el, az = math.radians(ax.elev), math.radians(ax.azim)
    cx, cy = (b.x0 + b.x1) / 2, (b.y0 + b.y1) / 2
    scale = 0.3 * min(b.x1 - b.x0, b.y1 - b.y0)

    def proj(p):
        u = (np.asarray(p, np.float64) - lo) / (hi - lo) * 2 - 1
        x, y, z = u[..., 0], u[..., 1], u[..., 2]
        sx = -math.sin(az) * x + math.cos(az) * y
        depth = math.cos(el) * (math.cos(az) * x + math.sin(az) * y) + math.sin(el) * z
        sy = -math.sin(el) * (math.cos(az) * x + math.sin(az) * y) + math.cos(el) * z
        return cx + scale * sx, cy - scale * sy, depth

    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], np.float64)
    cpts = lo + corners * (hi - lo)
    X, Y, _ = proj(cpts)
    for i in range(8):
        for j in range(i + 1, 8):
            if np.abs(corners[i] - corners[j]).sum() == 1:
                cv.line(X[i], Y[i], X[j], Y[j], 0.8, GREY)
    for axis, name in ((0, "set_xlabel"), (1, "set_ylabel"), (2, "set_zlabel")):
        call = ax.last(name)
        if call is None:
            continue
        mid = lo.copy()
        mid[axis] = (lo[axis] + hi[axis]) / 2
        mx, my, _ = proj(mid)
        cv.text(call.args[0], float(mx), float(my) + 8 * cv.pt, FONT_PT,
                va="top")
    if len(allp):
        P = np.concatenate(pts)
        X, Y, D = proj(P)
        for i in np.argsort(-D):
            if np.isfinite([X[i], Y[i]]).all():
                cv.disc(float(X[i]), float(Y[i]), math.sqrt(sizes[i]) / 2 * cv.pt,
                        cols[i])
    for c in texts:
        x, y, z, s = c.args
        tx, ty, _ = proj([x, y, z])
        cv.text(s, float(tx), float(ty), float(c.kwargs.get("fontsize", FONT_PT)),
                ha="left", va="baseline")


def draw(fig: Figure, dpi: float) -> np.ndarray:
    W = int(round(fig.figsize[0] * dpi))
    H = int(round(fig.figsize[1] * dpi))
    cv = Canvas(H, W, dpi)
    lay = layout(cv, fig)
    boxes = lay["boxes"]
    fig.boxes = [(b.x0, b.y0, b.x1, b.y1) for b in (boxes[id(ax)]
                                                  for ax in fig.axes)]
    image_panels(fig, boxes)
    for ax in fig.axes:
        for c in ax.calls:
            if c.name == "imshow":
                y0, x0, _, _ = c.out["panel"]
                _blit(cv, y0, x0, c.out["panel_rgba"])
    for c, rect in lay["colorbars"]:
        _colorbar(cv, c, rect)
    for ax in fig.axes:
        b = boxes[id(ax)]
        if ax.projection == "3d":
            _axes3d(cv, ax, b)
        else:
            _bars(cv, ax, b)
            _lines(cv, ax, b)
            if not ax.is_off():
                _frame(cv, b)
                _ticks(cv, ax, b)
                left, bottom, _ = _margins(cv, ax, (b.xlo, b.xhi, b.ylo, b.yhi))
                _labels(cv, ax, b, left, bottom)
            _texts(cv, ax, b)
            _legend(cv, ax, b)
        title = ax.last("set_title")
        if title is not None:
            size = float(title.kwargs.get("fontsize", TITLE_PT))
            cv.text(title.args[0], (b.x0 + b.x1) / 2, b.y0 - 6 * cv.pt, size,
                    va="bottom")
    if lay["suptitle"] is not None:
        cv.text(lay["suptitle"].args[0], W / 2, 6 * cv.pt, TITLE_PT, va="top")
    return np.rint(np.clip(cv.a, 0.0, 1.0) * 255.0).astype(np.uint8)
