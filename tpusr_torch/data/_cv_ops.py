"""The OpenCV operations of the EDA (``tpusr/data/eda.py``) as tensor ops
on the image's device, each written to give what the cv2 call gives on
x86: integer results bit for bit, float results in float64.

Images are (H, W, C) or (H, W) uint8 tensors in OpenCV's BGR order.

- ``resize_u8``: ``cv2.resize`` of a uint8 image as OpenCV 5 on x86
  computes it, path by path. ``INTER_CUBIC`` from a source of at least
  4x4 goes to Intel IPP (OpenCV's IPP HAL): float32 taps of the cubic
  (B 0, C 0.75) from the double source coordinate, a horizontal float32
  pass, a vertical pass whose products pair up with one fused
  multiply-add each, round half to even (``ipp_cubic``). ``INTER_AREA``
  shrinking both sides takes ``resizeAreaFast`` at integral ratios (the
  integer cell sum, ``(s + 2) >> 2`` at x2, else ``s * (1/k^2)`` in
  float32) and ``resizeArea`` otherwise (float32 cell weights summed row
  by row in OpenCV's order). Every other resize, enlarging or shrinking,
  takes OpenCV's generic path: taps from float32 coordinates without
  clamping at the borders (indices replicate the edge), a horizontal pass
  of integer taps (x 2048), and a vertical pass that is integer for
  ``INTER_LANCZOS4`` and OpenCV's 16-bit ``mulhi`` SIMD sum
  (``VResizeLinear``) for ``INTER_LINEAR``/``INTER_AREA``; for
  ``INTER_CUBIC`` from a source under 4x4, float32 in steps of 8 values
  (``VResizeCubicVec_32s8u``, no fused multiply-add) and OpenCV's integer
  ``VResizeCubic`` for the rest of each row. IPP takes no
  uint8 ``INTER_LINEAR`` or ``INTER_LANCZOS4`` resize in this cv2 (the same
  bytes with ``cv2.ipp.setUseIPP(False)``), and an exact x2
  ``INTER_LINEAR`` shrink, which OpenCV hands to ``resizeAreaFast``, gives
  the generic path's bytes too.
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


def _area_table(in_size: int, out_size: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: per output, the (source index,
    float32 weight) of each source sample its cell covers, in order, as
    (out, k) arrays padded with weight 0."""
    rows = []
    for d in range(out_size):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, in_size - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, in_size - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(r) for r in rows)
    idx = np.zeros((out_size, k), np.int64)
    wts = np.zeros((out_size, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (i, a) in enumerate(taps):
            idx[d, j], wts[d, j] = i, np.float32(a)
    return idx, wts


def _area_shrink(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """``INTER_AREA`` with both sides shrinking (``resizeAreaFast`` /
    ``resizeArea``)."""
    h, w, c = img.shape
    sx, sy = 1.0 / (ow / w), 1.0 / (oh / h)
    ix, iy = int(round(sx)), int(round(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        s = img.to(torch.int32).reshape(oh, iy, ow, ix, c).sum((1, 3))
        if (ix, iy) == (2, 2) and c in (1, 3, 4):
            return ((s + 2) >> 2).to(torch.uint8)
        v = s.to(torch.float32) * np.float32(1.0 / (ix * iy))
        return torch.round(v).clamp(0, 255).to(torch.uint8)
    dev = img.device
    xi, xw = (torch.from_numpy(a).to(dev) for a in _area_table(w, ow, sx))
    yi, yw = (torch.from_numpy(a).to(dev) for a in _area_table(h, oh, sy))
    x = img.to(torch.float32)
    buf = torch.zeros((h, ow, c), dtype=torch.float32, device=dev)
    for j in range(xi.shape[1]):             # buf[dx] += S[si] * alpha
        buf = buf + x[:, xi[:, j]] * xw[None, :, j, None]
    acc = buf[yi[:, 0]] * yw[:, 0, None, None]
    for j in range(1, yi.shape[1]):          # sum += beta * buf
        acc = acc + buf[yi[:, j]] * yw[:, j, None, None]
    return torch.round(acc).clamp(0, 255).to(torch.uint8)


def _ipp_cubic_taps(in_size: int, out_size: int):
    """(clamped source index (out, 4), float32 taps (out, 4)) of IPP's
    cubic: the fraction of the double source coordinate in float32, the
    outer taps as polynomials of it, the second as one minus the others."""
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src).astype(np.int64)
    t = (src - x0).astype(np.float32)
    f = np.float32
    t2 = t * t
    t3 = t2 * t
    w0 = f(-0.75) * t3 + f(1.5) * t2 + f(-0.75) * t
    w2 = f(-1.25) * t3 + f(1.5) * t2 + f(0.75) * t
    w3 = f(0.75) * t3 - f(0.75) * t2
    w1 = f(1) - w0 - w2 - w3
    idx = np.clip(x0[:, None] + np.arange(-1, 3), 0, in_size - 1)
    return idx, np.stack([w0, w1, w2, w3], 1).astype(np.float32)


def ipp_cubic(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """``INTER_CUBIC`` as IPP computes it for a uint8 image (see the module
    docstring); shrinking too."""
    h, w, c = img.shape
    dev = img.device
    xi, xw = (torch.from_numpy(a).to(dev) for a in _ipp_cubic_taps(w, ow))
    yi, yw = (torch.from_numpy(a).to(dev) for a in _ipp_cubic_taps(h, oh))
    p = img.to(torch.float32)[:, xi] * xw[None, :, :, None]   # (h, ow, 4, c)
    hor = (p[:, :, 0] + p[:, :, 1]) + (p[:, :, 2] + p[:, :, 3])
    rows = hor[yi]                                           # (oh, 4, ow, c)
    b = yw[:, :, None, None]

    def fma_pair(i, j):   # fma(r_i, b_i, r_j * b_j), rounded once
        prod = (rows[:, j] * b[:, j]).double()
        return (rows[:, i].double() * b[:, i].double() + prod).float()

    v = fma_pair(0, 1) + fma_pair(2, 3)
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def resize_u8(img: torch.Tensor, out_hw: tuple[int, int],
              method: str) -> torch.Tensor:
    """``cv2.resize`` of an (H, W, C) uint8 image to ``out_hw`` with one of
    ``bilinear``, ``bicubic``, ``area`` or ``lanczos4`` (see the module
    docstring)."""
    h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if method == "bicubic" and h >= 4 and w >= 4:
        return ipp_cubic(img, oh, ow)
    if method == "area" and oh <= h and ow <= w:
        return _area_shrink(img, oh, ow)
    dev = img.device
    xi, xt = (torch.from_numpy(a).to(dev) for a in _resize_taps(w, ow, method))
    yi, yt = (torch.from_numpy(a).to(dev) for a in _resize_taps(h, oh, method))
    x = img.to(torch.int64)
    hor = (x[:, xi] * xt[None, :, :, None]).sum(2).reshape(h, ow * c)
    rows = hor[yi]                                   # (oh, k, ow*c)
    if method == "lanczos4":
        v = ((rows * yt[:, :, None]).sum(1) + (1 << 21)) >> 22
    elif method == "bicubic":
        # VResizeCubicVec_32s8u: 8 values a step in float32, s0*b0 + (s1*b1
        # + (s2*b2 + s3*b3)), each product and sum rounded; the last
        # ow*c % 8 values (all of a row under 8) in VResizeCubic's integer
        # sum, rounded at 22 bits
        s = rows.to(torch.float32)
        b = yt.to(torch.float32) * np.float32(1.0 / (_COEF_SCALE * _COEF_SCALE))
        acc = s[:, 3] * b[:, 3, None]
        for k in (2, 1, 0):
            acc = s[:, k] * b[:, k, None] + acc
        v = torch.round(acc).to(torch.int64)
        simd = (ow * c) // 8 * 8
        v[:, simd:] = ((rows[:, :, simd:] * yt[:, :, None]).sum(1)
                       + (1 << 21)) >> 22
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


# ----------------------------------------------- threshold and contours
def otsu_threshold(gray: torch.Tensor) -> tuple[float, torch.Tensor]:
    """``cv2.threshold(gray, 0, 255, THRESH_BINARY + THRESH_OTSU)`` of an
    (H, W) uint8 image: the threshold (the histogram on the image's device,
    OpenCV's search over it in float64 on the host) and the uint8 mask, 255
    where ``gray > threshold``."""
    hist = torch.bincount(gray.reshape(-1).long(), minlength=256).cpu().numpy()
    scale = 1.0 / gray.numel()
    mu = float(np.dot(np.arange(256, dtype=np.float64), hist)) * scale
    mu1 = q1 = 0.0
    max_sigma = max_val = 0.0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, float(i)
    return max_val, (gray.to(torch.int32) > max_val).to(torch.uint8) * 255


# OpenCV's chain-code directions: (dx, dy) of 0 = east, counter-clockwise
_DIRS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _trace_outer(lab: np.ndarray, y: int, x: int) -> list:
    """OpenCV's ``icvFetchContour`` of the outer border that starts at
    (y, x) of the zero-framed label image ``lab`` (0 background, 1
    unvisited foreground): marks the border's pixels (negative where the
    pixel's east neighbour was seen to be background, else positive) and
    returns its CHAIN_APPROX_SIMPLE points (x, y) in the framed image."""
    width = lab.shape[1]
    flat = lab.reshape(-1)
    deltas = [dy * width + dx for dx, dy in _DIRS] * 2
    i0 = y * width + x
    s = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if flat[i1] != 0 or s == 4:
            break
    if s == 4 and flat[i1] == 0:                 # a single pixel
        flat[i0] = -2
        return [(x, y)]
    pts = []
    px, py = x, y
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if flat[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            flat[i3] = -2
        elif flat[i3] == 1:
            flat[i3] = 2
        if s != prev_s:
            pts.append((px, py))
            prev_s = s
        px += _DIRS[s][0]
        py += _DIRS[s][1]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def external_contours(mask: torch.Tensor) -> list[np.ndarray]:
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]`` of
    an (H, W) mask (nonzero = foreground) as (n, 2) int64 arrays of (x, y),
    in OpenCV's order. The border following is OpenCV's, on the host, over
    the mask framed by a row and column of zeros; a border is traced when
    its first pixel is met in raster order and the last traced pixel to
    its left on that row is not one of an enclosing border (OpenCV's
    ``lnbd`` test), so blobs inside holes are left out. OpenCV lists the
    contours last found first."""
    m = (mask != 0).cpu().numpy()
    lab = np.zeros((m.shape[0] + 2, m.shape[1] + 2), np.int8)
    lab[1:-1, 1:-1] = m
    found = []
    for y in np.nonzero(m.any(axis=1))[0] + 1:
        row = lab[y]
        starts = np.nonzero((row[1:] == 1) & (row[:-1] == 0))[0] + 1
        for x in starts:
            if row[x] != 1:
                continue
            marked = np.nonzero(np.abs(row[:x]) >= 2)[0]
            if len(marked) and row[marked[-1]] > 0:
                continue                          # inside a traced border
            pts = np.asarray(_trace_outer(lab, int(y), int(x)), np.int64)
            found.append(pts - 1)
    return found[::-1]


def contour_area(pts: np.ndarray) -> float:
    """``cv2.contourArea``: the shoelace area of the polygon."""
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    return abs(float(np.sum(xp * y - yp * x)) * 0.5)


def bounding_rect(pts: np.ndarray) -> tuple[int, int, int, int]:
    """``cv2.boundingRect`` of a point set: (x, y, w, h)."""
    lo, hi = pts.min(0), pts.max(0)
    return int(lo[0]), int(lo[1]), int(hi[0] - lo[0] + 1), int(hi[1] - lo[1] + 1)
