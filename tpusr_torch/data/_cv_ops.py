"""The OpenCV operations of the EDA (``tpusr/data/eda.py``) as tensor ops
on the image's device, each written to give what the cv2 call gives on
x86: integer results bit for bit, float results in float64.

Images are (H, W, C) or (H, W) uint8 tensors in OpenCV's BGR order.

- ``resize_u8``: ``cv2.resize`` of a uint8 image when enlarging, as
  OpenCV's generic path computes it: taps from float32 coordinates without
  clamping at the borders (indices replicate the edge), a horizontal pass of
  integer taps (x 2048), and a vertical pass that is integer for
  ``INTER_LANCZOS4``, OpenCV's float32 SIMD sum for ``INTER_CUBIC`` and its
  16-bit ``mulhi`` SIMD sum for ``INTER_LINEAR``/``INTER_AREA``. Exact at
  integral ratios; shrinking goes through ``core/resize.py`` and rounds.
- ``bgr2gray``, ``bgr2hsv_sv``: the fixed-point ``cvtColor`` (gray
  ``(B*3735 + G*19235 + R*9798 + 2^14) >> 15``, the 15-bit weights OpenCV
  4.x/5.x uses, not the 14-bit ``1868/9617/4899`` of its older releases; S
  from cv2's division table).
- ``gaussian_blur_u8``: ``GaussianBlur`` 3x3 or 5x5 at sigma 0: binomial
  integer taps summed in int32, one rounding, BORDER_REFLECT_101.
- ``correlate`` (``cv2.filter2D`` with the default anchor), ``laplacian``,
  ``sobel5``: correlations in float64 with BORDER_REFLECT_101.
- ``dct2``: ``cv2.dct`` of a 2-D array, the orthonormal DCT-II, as two
  matrix products in float64 (at odd sizes too, as cv2 computes them).
- ``canny``: ``Canny(gray, low, high)`` with the 3x3 Sobel at
  BORDER_REPLICATE, the L1 magnitude, OpenCV's fixed-point tan 22.5 test and
  its asymmetric ``>``/``>=`` non-maximum suppression, and 8-connected
  hysteresis as a dilation repeated to a fixed point.
- ``dilate``: a square of ones, as a max-pool.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpusr_torch.core.resize import resize as _resize_f32

_COEF_SCALE = 2048          # INTER_RESIZE_COEF_SCALE
_KSIZE = {"bilinear": 2, "area": 2, "bicubic": 4, "lanczos4": 8}


# ------------------------------------------------------------------ resize
def _cubic_taps(x: np.float32) -> list:
    a = np.float32(-0.75)
    one = np.float32(1)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) \
        * (x + one) - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    c2 = ((a + np.float32(2)) * (one - x) - (a + np.float32(3))) * (one - x) \
        * (one - x) + one
    return [c0, c1, c2, one - c0 - c1 - c2]


def _lanczos4_taps(x: np.float32) -> list:
    if x < np.finfo(np.float32).eps:
        return [np.float32(0)] * 3 + [np.float32(1)] + [np.float32(0)] * 4
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45),
          (0, -1), (-s45, s45))
    y0 = -(float(x) + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    taps, total = [], np.float32(0)
    for i in range(8):
        y = -(float(x) + 3 - i) * math.pi * 0.25
        taps.append(np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y)))
        total = np.float32(total + taps[-1])
    inv = np.float32(np.float32(1) / total)
    return [np.float32(t * inv) for t in taps]


def _resize_taps(in_size: int, out_size: int, method: str):
    """(source index of each output's first tap (out, k) clamped to the
    image, integer taps (out, k)): OpenCV's ``resize`` coefficient tables
    for an 8-bit image."""
    k = _KSIZE[method]
    inv = out_size / in_size
    scale = 1.0 / inv
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, k), np.int64)
    for dx in range(out_size):
        if method == "area":
            sx = math.floor(dx * scale)
            fx = np.float32((dx + 1) - (sx + 1) * inv)
            fx = np.float32(0) if fx <= 0 else np.float32(fx - np.floor(fx))
        else:
            fx = np.float32((dx + 0.5) * scale - 0.5)
            sx = int(np.floor(fx))
            fx = np.float32(fx - np.float32(sx))
        if method == "bicubic":
            c = _cubic_taps(fx)
        elif method == "lanczos4":
            c = _lanczos4_taps(fx)
        else:
            c = [np.float32(1) - fx, fx]
        first[dx] = sx - k // 2 + 1
        taps[dx] = np.rint(np.asarray(c, np.float32) * np.float32(_COEF_SCALE))
    idx = np.clip(first[:, None] + np.arange(k), 0, in_size - 1)
    return idx, taps


def resize_u8(img: torch.Tensor, out_hw: tuple[int, int],
              method: str) -> torch.Tensor:
    """``cv2.resize`` of an (H, W, C) uint8 image to ``out_hw`` with one of
    ``bilinear``, ``bicubic``, ``area`` or ``lanczos4`` (see the module
    docstring)."""
    h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh < h or ow < w:
        # shrinking: the float filter, rounded (not OpenCV's 8-bit path)
        return _resize_f32(img.float(), (oh, ow), method).round().clamp(
            0, 255).to(torch.uint8)
    dev = img.device
    xi, xt = (torch.from_numpy(a).to(dev) for a in _resize_taps(w, ow, method))
    yi, yt = (torch.from_numpy(a).to(dev) for a in _resize_taps(h, oh, method))
    x = img.to(torch.int64)
    hor = (x[:, xi] * xt[None, :, :, None]).sum(2).reshape(h, ow * c)
    rows = hor[yi]                                   # (oh, k, ow*c)
    if method == "lanczos4":
        v = ((rows * yt[:, :, None]).sum(1) + (1 << 21)) >> 22
    elif method == "bicubic":
        s = rows.to(torch.float32)
        b = yt.to(torch.float32) * np.float32(1.0 / (_COEF_SCALE * _COEF_SCALE))

        def fma_pair(i, j):   # fma(s_i, b_i, s_j * b_j), rounded once
            prod = (s[:, j] * b[:, j, None]).double()
            return (s[:, i].double() * b[:, i, None].double() + prod).float()

        v = torch.round(fma_pair(0, 1) + fma_pair(2, 3)).to(torch.int64)
    else:
        s = (rows >> 4).clamp(-32768, 32767)
        t = ((s[:, 0] * yt[:, 0, None]) >> 16) + ((s[:, 1] * yt[:, 1, None]) >> 16)
        v = (t.clamp(-32768, 32767) + 2) >> 2
    return v.clamp(0, 255).to(torch.uint8).reshape(oh, ow, c)


# ------------------------------------------------------------ colour
def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """``cvtColor(BGR2GRAY)`` of a uint8 image."""
    x = img.to(torch.int32)
    g = x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)
    return (g >> 15).to(torch.uint8)


def _sdiv_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    t[1:] = np.rint((255 << 12) / np.arange(1, 256, dtype=np.float64))
    return t


_SDIV = _sdiv_table()


def bgr2hsv_sv(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The S and V planes of ``cvtColor(BGR2HSV)`` of a uint8 image."""
    x = img.to(torch.int64)
    v = x.amax(dim=-1)
    diff = v - x.amin(dim=-1)
    sdiv = torch.from_numpy(_SDIV).to(img.device)[v]
    s = (diff * sdiv + (1 << 11)) >> 12
    return s.to(torch.uint8), v.to(torch.uint8)


# ------------------------------------------------------------- filters
def _pad(x: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad the two leading (image) dims of an (H, W) or (H, W, C) tensor:
    ``reflect`` is OpenCV's BORDER_REFLECT_101, ``replicate`` its
    BORDER_REPLICATE."""
    two_d = x.dim() == 2
    t = x[None, None] if two_d else x.permute(2, 0, 1)[None]
    dt = t.dtype
    if not dt.is_floating_point:
        t = t.double()
    if mode == "reflect" and (x.shape[0] <= p or x.shape[1] <= p):
        t = _reflect101_small(t, p)
    else:
        t = F.pad(t, (p, p, p, p), mode=mode)
    t = t.to(dt)
    return t[0, 0] if two_d else t[0].permute(1, 2, 0)


def _reflect101_small(t: torch.Tensor, p: int) -> torch.Tensor:
    """BORDER_REFLECT_101 where the image is not wider than the pad."""
    def idx(n):
        i = np.arange(-p, n + p)
        if n == 1:
            return np.zeros_like(i)
        period = 2 * n - 2
        i = np.abs(i) % period
        return np.where(i >= n, period - i, i)

    h, w = t.shape[-2:]
    t = t[..., torch.from_numpy(idx(h)).to(t.device), :]
    return t[..., torch.from_numpy(idx(w)).to(t.device)]


def correlate(x: torch.Tensor, kernel, border: str = "reflect") -> torch.Tensor:
    """2-D correlation of an (H, W) or (H, W, C) tensor with a (k, k)
    kernel (``cv2.filter2D`` with the default anchor), in x's float dtype
    or, for an integer x, in int64 with an integer kernel."""
    k = torch.as_tensor(np.asarray(kernel))
    p = k.shape[0] // 2
    xp = _pad(x, p, border)
    if x.dtype.is_floating_point:
        k = k.to(x.device, x.dtype)
        out = torch.zeros_like(x)
    else:
        xp = xp.to(torch.int64)
        k = k.to(x.device, torch.int64)
        out = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    h, w = x.shape[:2]
    for dy in range(k.shape[0]):
        for dx in range(k.shape[1]):
            if k[dy, dx] != 0:
                out = out + k[dy, dx] * xp[dy: dy + h, dx: dx + w]
    return out


_LAPLACIAN = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)


def laplacian(gray: torch.Tensor) -> torch.Tensor:
    """``cv2.Laplacian(gray, CV_64F)`` (ksize 1)."""
    return correlate(gray.double(), _LAPLACIAN)


_SMOOTH5 = np.array([1, 4, 6, 4, 1], np.float64)
_DERIV5 = np.array([-1, -2, 0, 2, 1], np.float64)


def sobel5(gray: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``cv2.Sobel(gray, CV_64F, dx, dy, ksize=5)`` for (1, 0) or (0, 1)."""
    kx = _DERIV5 if dx else _SMOOTH5
    ky = _DERIV5 if dy else _SMOOTH5
    return correlate(gray.double(), np.outer(ky, kx))


_BINOMIAL = {3: np.array([1, 2, 1]), 5: np.array([1, 4, 6, 4, 1])}


def gaussian_blur_u8(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of a uint8 image, k 3 or 5: the
    binomial taps summed in integers, rounded half up once."""
    k1 = _BINOMIAL[ksize]
    total = int(k1.sum()) ** 2
    s = correlate(img, np.outer(k1, k1))
    return ((s + total // 2) // total).to(torch.uint8)


def _dct_matrix(n: int, device, dtype=torch.float64) -> torch.Tensor:
    k = torch.arange(n, dtype=dtype, device=device)[:, None]
    i = torch.arange(n, dtype=dtype, device=device)[None]
    m = torch.cos(math.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    m[0] = m[0] / math.sqrt(2.0)
    return m


def dct2(x: torch.Tensor) -> torch.Tensor:
    """``cv2.dct`` of a 2-D array: the orthonormal 2-D DCT-II, in float64."""
    x = x.double()
    h, w = x.shape
    return _dct_matrix(h, x.device) @ x @ _dct_matrix(w, x.device).T


# --------------------------------------------------------------- Canny
_SOBEL3_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])
_TG22 = 13573           # tan(22.5 deg) * 2^15, OpenCV's CANNY_SHIFT 15
_GROW_STEPS = 16        # hysteresis dilations between two fixed-point checks


def canny(gray: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``cv2.Canny(gray, low, high)`` (aperture 3, L1 magnitude) -> uint8
    edges (255 on an edge)."""
    lo, hi = math.floor(low), math.floor(high)
    if lo > hi:
        lo, hi = hi, lo
    g = gray.to(torch.int64)
    dx = correlate(g, _SOBEL3_X, "replicate")
    dy = correlate(g, _SOBEL3_X.T, "replicate")
    mag = dx.abs() + dy.abs()
    h, w = mag.shape
    m = F.pad(mag, (1, 1, 1, 1))          # magnitude 0 outside the image

    def at(oy, ox):
        return m[1 + oy: 1 + oy + h, 1 + ox: 1 + ox + w]

    ax, ay = dx.abs(), dy.abs() << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg67x)
    diagonal = ~horizontal & ~vertical
    s_neg = (dx ^ dy) < 0                   # the gradient's diagonal
    keep_h = (mag > at(0, -1)) & (mag >= at(0, 1))
    keep_v = (mag > at(-1, 0)) & (mag >= at(1, 0))
    keep_d = torch.where(s_neg, (mag > at(-1, 1)) & (mag > at(1, -1)),
                         (mag > at(-1, -1)) & (mag > at(1, 1)))
    nms = (mag > lo) & ((horizontal & keep_h) | (vertical & keep_v)
                        | (diagonal & keep_d))
    strong = (nms & (mag > hi)).float()
    weak = nms.float()
    # 8-connected hysteresis: grow the strong set through weak pixels
    n = int(strong.sum())
    while True:
        for _ in range(_GROW_STEPS):
            grown = F.max_pool2d(strong[None, None], 3, 1, 1)[0, 0]
            strong = torch.maximum(strong, grown * weak)
        total = int(strong.sum())
        if total == n:
            break
        n = total
    return (strong * 255).to(torch.uint8)


def dilate(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``cv2.dilate(mask, np.ones((size, size)))`` of a uint8 mask."""
    out = F.max_pool2d(mask[None, None].float(), size, 1, size // 2)
    return out[0, 0].to(torch.uint8)
