"""The colours of the port's figures: matplotlib's colormaps, its default
colour cycle and colour names, and OpenCV's ``COLORMAP_JET``, from the
tables in ``_tables.py``.

A colormap maps data as ``matplotlib.colormaps[name](Normalize(vmin,
vmax)(data), bytes=True)`` does, on ``imshow``'s masked data:

- ``Normalize``: the data in matplotlib's float type for it (uint8, int8,
  int16 and bool in float32, wider integers in float64, floats as they
  are), ``(x - vmin) / (vmax - vmin)`` in that type, vmin and vmax taken
  from the finite data where not given (as ``autoscale_None``), and all 0
  where vmin equals vmax;
- ``Colormap.__call__``: ``x * N``, ``N`` folded to ``N - 1``, truncated
  to an index; below 0 the under colour, at or above ``N`` the over
  colour, NaN or infinite the bad colour (transparent).

``rgba_tensor`` does it as a gather on the data's device; ``rgba_numpy``
does the same on the host, for checks.
"""

from __future__ import annotations

import base64
import functools
import zlib

import numpy as np
import torch

from tpusr_torch.viz import _tables

CYCLE = _tables.CYCLE
# matplotlib's single-letter base colours and the names the figures use
_NAMED = {"b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0),
          "c": (0.0, 0.75, 0.75), "m": (0.75, 0.0, 0.75),
          "y": (0.75, 0.75, 0.0), "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0),
          "black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0)}


def _unpack(b64: str, shape) -> np.ndarray:
    return np.frombuffer(zlib.decompress(base64.b64decode(b64)),
                         np.uint8).reshape(shape).copy()


def to_rgba(color, alpha: float | None = None) -> tuple:
    """matplotlib's ``to_rgba`` for the colours the figures name: ``#rgb``,
    ``#rrggbb``, ``#rrggbbaa``, ``C0``-``C9``, the base letters and
    ``black``/``white``; an RGB or RGBA tuple passes through. ``alpha``,
    where given, replaces the alpha."""
    if isinstance(color, str):
        c = color
        if c.startswith("#") and len(c) == 4:
            c = "#" + "".join(ch * 2 for ch in c[1:])
        if c.startswith("#") and len(c) in (7, 9):
            rgba = tuple(int(c[i:i + 2], 16) / 255 for i in range(1, len(c), 2))
            rgba = rgba if len(rgba) == 4 else (*rgba, 1.0)
        elif len(c) == 2 and c[0] == "C" and c[1].isdigit():
            return to_rgba(CYCLE[int(c[1])], alpha)
        elif c in _NAMED:
            rgba = (*_NAMED[c], 1.0)
        else:
            raise ValueError(f"{color!r} is not a colour the figures know")
    else:
        rgba = tuple(float(v) for v in color)
        rgba = rgba if len(rgba) == 4 else (*rgba, 1.0)
    if alpha is not None:
        rgba = (*rgba[:3], float(alpha))
    return rgba


@functools.lru_cache(maxsize=None)
def _jet() -> np.ndarray:
    """OpenCV's ``COLORMAP_JET``: (256, 3) uint8 BGR."""
    return _unpack(_tables.JET_BGR, (256, 3))


def apply_color_map_jet(gray: torch.Tensor) -> torch.Tensor:
    """``cv2.applyColorMap(gray, cv2.COLORMAP_JET)`` of an (H, W) uint8
    tensor: (H, W, 3) uint8 BGR, a gather on gray's device."""
    lut = torch.from_numpy(_jet()).to(gray.device)
    return lut[gray.long()]


# matplotlib's Normalize: the float type it computes in, for a data type
def norm_dtype(dtype: np.dtype) -> np.dtype:
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer) or dtype == np.bool_:
        return np.promote_types(dtype, np.float32)
    if dtype == np.float16:
        return np.dtype(np.float32)
    return dtype


def _scalar(v) -> np.generic:
    """``Normalize.process_value`` of a scalar limit."""
    dt = np.min_scalar_type(v)
    if np.issubdtype(dt, np.integer) or dt == np.bool_:
        dt = np.promote_types(dt, np.float32)
    return np.asarray(v).astype(dt)[()]


_TORCH_TO_NP = {torch.uint8: np.uint8, torch.int8: np.int8,
                torch.int16: np.int16, torch.int32: np.int32,
                torch.int64: np.int64, torch.bool: np.bool_,
                torch.float16: np.float16, torch.bfloat16: np.float32,
                torch.float32: np.float32, torch.float64: np.float64}


class Colormap:
    """One of matplotlib's colormaps, as its ``bytes=True`` table."""

    def __init__(self, name: str):
        n3, b64 = _tables.LUTS[name]
        self.name = name
        self.lut = _unpack(b64, (n3, 4))          # N colours, under, over, bad
        self.N = n3 - 3

    def rgba_numpy(self, data, vmin=None, vmax=None) -> np.ndarray:
        """(..., 4) uint8 of ``data`` on the host."""
        x = np.asarray(data)
        dt = norm_dtype(x.dtype)
        r = x.astype(dt)
        bad = ~np.isfinite(r)
        fin = r[~bad]
        lo = (fin.min() if fin.size else dt.type(0)) if vmin is None \
            else dt.type(_scalar(vmin))
        hi = (fin.max() if fin.size else dt.type(0)) if vmax is None \
            else dt.type(_scalar(vmax))
        if lo > hi:
            raise ValueError("minvalue must be less than or equal to maxvalue")
        with np.errstate(invalid="ignore", divide="ignore"):
            r = np.zeros_like(r) if lo == hi else (r - lo) / (hi - lo)
        r = r * dt.type(self.N)
        r[r == self.N] = self.N - 1
        under, over = r < 0, r >= self.N
        with np.errstate(invalid="ignore"):
            idx = np.where(bad, 0, r).astype(np.int64)
        idx[under] = self.N
        idx[over] = self.N + 1
        idx[bad] = self.N + 2
        return self.lut[idx]

    def rgba_tensor(self, data: torch.Tensor, vmin=None,
                    vmax=None) -> torch.Tensor:
        """(..., 4) uint8 of ``data`` on its device: the arithmetic of
        ``rgba_numpy``, then one gather from the table."""
        dt = torch.from_numpy(np.zeros(0, norm_dtype(_TORCH_TO_NP[
            data.dtype]))).dtype
        r = data.to(dt)
        bad = ~torch.isfinite(r)
        # the limits stay on the device: no read back to the host
        inf = torch.tensor(float("inf"), dtype=dt, device=r.device)
        lo = (torch.where(bad, inf, r).amin() if vmin is None
              else torch.tensor(float(_scalar(vmin)), dtype=dt, device=r.device))
        hi = (torch.where(bad, -inf, r).amax() if vmax is None
              else torch.tensor(float(_scalar(vmax)), dtype=dt, device=r.device))
        if (vmin is None) != (vmax is None) and bool(lo > hi):
            raise ValueError("minvalue must be less than or equal to maxvalue")
        if vmin is not None and vmax is not None and float(lo) > float(hi):
            raise ValueError("minvalue must be less than or equal to maxvalue")
        flat = (lo == hi) | ~torch.isfinite(lo)       # no finite data: all 0
        r = torch.where(flat, torch.zeros_like(r), (r - lo) / (hi - lo))
        r = r * self.N
        r = torch.where(r == self.N, torch.full_like(r, self.N - 1), r)
        idx = torch.where(bad, torch.zeros_like(r), r).to(torch.int64)
        idx = torch.where(r < 0, self.N, idx)
        idx = torch.where(r >= self.N, self.N + 1, idx)
        idx = torch.where(bad, self.N + 2, idx)
        return torch.from_numpy(self.lut).to(data.device)[idx]


@functools.lru_cache(maxsize=None)
def get_cmap(name: str) -> Colormap:
    if name not in _tables.LUTS:
        raise ValueError(f"colormap {name!r} is not one of the port's "
                         f"{sorted(_tables.LUTS)}")
    return Colormap(name)
