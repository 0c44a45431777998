"""The port's bitmap font: DejaVu Sans glyphs (``_tables.GLYPH_*``: ASCII
32-126 and the em dash the figure titles use) scaled to the text's size by
area averaging and rotated by any angle (the figures use 0, 30, 45, 60 and
90 degrees) with bilinear sampling.

A character the font lacks is drawn as a box the width of an ``n`` and
counted in ``MISSING`` (character -> count): it is never dropped
silently."""

from __future__ import annotations

import base64
import collections
import functools
import math
import zlib

import numpy as np

from tpusr_torch.viz import _tables

MISSING: collections.Counter = collections.Counter()
LINE_SPACING = 1.2          # matplotlib's text linespacing


@functools.lru_cache(maxsize=None)
def _atlas() -> np.ndarray:
    raw = zlib.decompress(base64.b64decode(_tables.GLYPH_ATLAS))
    a = np.frombuffer(raw, np.uint8).reshape(_tables.GLYPH_ROWS, -1)
    return a.astype(np.float32) / 255.0


@functools.lru_cache(maxsize=None)
def _box() -> tuple[np.ndarray, float]:
    """The cell of a missing character: a box outline."""
    adv = _tables.GLYPH_CELLS["n"][2]
    w = int(math.ceil(adv))
    cell = np.zeros((_tables.GLYPH_ROWS, w), np.float32)
    top = _tables.GLYPH_BASELINE - int(0.72 * _tables.GLYPH_PX)
    base = _tables.GLYPH_BASELINE
    x0, x1 = 2, w - 3
    cell[top:base, x0:x0 + 2] = cell[top:base, x1:x1 + 2] = 1.0
    cell[top:top + 2, x0:x1 + 2] = cell[base - 2:base, x0:x1 + 2] = 1.0
    return cell, adv


def _glyph(ch: str) -> tuple[np.ndarray, float]:
    cell = _tables.GLYPH_CELLS.get(ch)
    if cell is None:
        return _box()
    x0, w, adv = cell
    return _atlas()[:, x0:x0 + w], adv


def _line(s: str) -> np.ndarray:
    """Coverage of one line at the stored size (GLYPH_ROWS rows)."""
    glyphs = [_glyph(ch) for ch in s]
    pen, xs = 0.0, []
    for g, adv in glyphs:
        xs.append(int(round(pen)))
        pen += adv
    width = max([x + g.shape[1] for x, (g, _) in zip(xs, glyphs)]
                + [int(math.ceil(pen)), 1])
    out = np.zeros((_tables.GLYPH_ROWS, width), np.float32)
    for x, (g, _) in zip(xs, glyphs):
        np.maximum(out[:, x:x + g.shape[1]], g, out=out[:, x:x + g.shape[1]])
    return out


def _area_axis(a: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """Area-averaging resample of ``a`` along ``axis`` to ``n_out``
    samples, from the running sum at the output cells' edges."""
    a = np.moveaxis(a, axis, -1)
    n_in = a.shape[-1]
    cs = np.concatenate([np.zeros(a.shape[:-1] + (1,), np.float32),
                         np.cumsum(a, -1, dtype=np.float32)], -1)
    edges = np.arange(n_out + 1) * (n_in / n_out)
    i = np.minimum(np.floor(edges).astype(np.int64), n_in - 1)
    at = cs[..., i] + (edges - i).astype(np.float32) * a[..., i]
    out = (at[..., 1:] - at[..., :-1]) * np.float32(n_out / n_in)
    return np.moveaxis(out, -1, axis)


def _scale(a: np.ndarray, f: float) -> np.ndarray:
    h = max(1, int(round(a.shape[0] * f)))
    w = max(1, int(round(a.shape[1] * f)))
    return _area_axis(_area_axis(a, h, 0), w, 1)


def _rotate(a: np.ndarray, deg: float) -> np.ndarray:
    """``a`` turned counter-clockwise by ``deg``, on a canvas that holds it
    whole, sampled bilinearly."""
    t = math.radians(deg)
    c, s = math.cos(t), math.sin(t)
    h, w = a.shape
    oh = int(math.ceil(abs(h * c) + abs(w * s))) + 1
    ow = int(math.ceil(abs(w * c) + abs(h * s))) + 1
    yy, xx = np.mgrid[0:oh, 0:ow].astype(np.float32)
    yy -= (oh - 1) / 2
    xx -= (ow - 1) / 2
    # inverse map: screen y grows down, so a ccw turn on screen is cw in (x, y)
    sx = c * xx - s * yy + (w - 1) / 2
    sy = s * xx + c * yy + (h - 1) / 2
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    pad = np.pad(a, 1)
    out = np.zeros((oh, ow), np.float32)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yi = np.clip(y0 + dy + 1, 0, h + 1)
            xi = np.clip(x0 + dx + 1, 0, w + 1)
            out += pad[yi, xi] * wy * wx
    return out


def render(text: str, px: float, rotation: float = 0.0,
           align: str = "center") -> tuple[np.ndarray, float]:
    """(coverage in [0, 1] of ``text`` at ``px`` pixels per em, turned
    counter-clockwise by ``rotation`` degrees, rows of the first line's
    baseline from the top when unturned). Lines split at ``\\n`` are
    ``align``-ed (left, center, right) within the block. The result is
    shared between calls: do not write to it."""
    for ch in text:
        if ch != "\n" and ch not in _tables.GLYPH_CELLS:
            MISSING[ch] += 1
    return _render(text, float(px), float(rotation) % 360, align)


@functools.lru_cache(maxsize=4096)
def _render(text: str, px: float, rotation: float,
            align: str) -> tuple[np.ndarray, float]:
    lines = [_line(s) for s in text.split("\n")]
    step = int(round(_tables.GLYPH_PX * LINE_SPACING))
    width = max(ln.shape[1] for ln in lines)
    rows = _tables.GLYPH_ROWS + step * (len(lines) - 1)
    block = np.zeros((rows, width), np.float32)
    for i, ln in enumerate(lines):
        x = {"left": 0, "right": width - ln.shape[1]}.get(
            align, (width - ln.shape[1]) // 2)
        block[i * step:i * step + ln.shape[0], x:x + ln.shape[1]] = ln
    f = px / _tables.GLYPH_PX
    out = np.clip(_scale(block, f), 0.0, 1.0)
    baseline = _tables.GLYPH_BASELINE * f
    if rotation:
        out = np.clip(_rotate(out, rotation), 0.0, 1.0)
    out.setflags(write=False)
    return out, baseline
