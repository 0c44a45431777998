"""Image quality metrics of the classic-SR comparison (port of the parts of
``tpusr/metrics/image.py`` that ``classic/harness.py`` uses).

Every function takes and returns tensors on the caller's device and reads
nothing back to the host, so a metric block runs as a chain of launches.
Filters are ``F.conv2d`` in float32 with TF32 off, as the JAX package left
them to XLA at HIGHEST precision. The profiling metrics follow the reference
study's ``profiling_methods.py:45-164``; ``ssim_skimage`` follows
``skimage.metrics.structural_similarity``'s defaults.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusr_torch.core.pad import pad_2d
from tpusr_torch.device import fp32_math

_EPS = 1e-9


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _separable_valid(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable VALID filter of a 2-D image: the column pass, then the row
    pass, ``taps`` in float32."""
    fp32_math()
    k = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
    y = F.conv2d(x[None, None], k.reshape(1, 1, -1, 1))
    return F.conv2d(y, k.reshape(1, 1, 1, -1))[0, 0]


# ------------------------------------------------------------------ SSIM
def ssim_skimage(y_true: torch.Tensor, y_pred: torch.Tensor,
                 data_range=1.0, win_size: int = 7,
                 channel_axis: int | None = None) -> torch.Tensor:
    """skimage.metrics.structural_similarity parity (7x7 uniform window,
    sample covariance); with ``channel_axis`` the mean over channels."""
    x, y = _f32(y_true), _f32(y_pred)
    if channel_axis is not None:
        vals = [ssim_skimage(x.select(channel_axis, c), y.select(channel_axis, c),
                             data_range, win_size)
                for c in range(x.shape[channel_axis])]
        return torch.stack(vals).mean()

    win = np.full((win_size,), 1.0 / win_size)

    def ufilt(a):
        return _separable_valid(a, win)

    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1.0)  # sample covariance
    ux, uy = ufilt(x), ufilt(y)
    uxx, uyy, uxy = ufilt(x * x), ufilt(y * y), ufilt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    # the VALID map is already skimage's map cropped by (win-1)//2 a side
    return s.mean()


# ---------------------------------------------------------------- error stats
def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (profiling_methods.py:45-47)."""
    return (_f32(a) - _f32(b)).abs().mean()


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Root mean squared error with the reference's epsilon
    (profiling_methods.py:49-53)."""
    d = _f32(a) - _f32(b)
    return torch.sqrt((d * d).mean() + _EPS)


# ----------------------------------------------------------------- edge stats
_GRAY_W = [float(v) for v in np.array([0.299, 0.587, 0.114], np.float32)]


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor RGB2GRAY weights (0.299, 0.587, 0.114) in float32.

    The sum is rounded as the JAX package's dot rounds it on the CPU: the
    first product, then two fused multiply-adds. Each fused step is exact in
    float64 for 8-bit values before its one rounding to float32, so a
    uint8-valued image gets the JAX package's gray bit for bit, and the
    harness's gray rounding never flips a pixel the JAX package does not.
    """
    x = img.double()
    acc = (x[..., 0] * _GRAY_W[0]).float()
    acc = (acc.double() + x[..., 1] * _GRAY_W[1]).float()
    return (acc.double() + x[..., 2] * _GRAY_W[2]).float()


def _ensure_gray01(img: torch.Tensor) -> torch.Tensor:
    """profiling_methods._ensure_gray_f32: gray float32 scaled to [0, 1]."""
    if img.dim() == 3:
        img = rgb_to_gray(img)
    img = _f32(img)
    return torch.where(img.max() > 1.5, img / 255.0, img)


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = _SOBEL_X.T


def conv3x3_reflect101(img: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """3x3 correlation of a 2-D image with cv2's default BORDER_REFLECT_101
    (= ``np.pad(mode='reflect')``)."""
    fp32_math()
    k = torch.as_tensor(np.asarray(kern, np.float32), device=img.device)
    return F.conv2d(pad_2d(img, 1)[None, None], k[None, None])[0, 0]


def sobel_mag(img: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude (profiling_methods.py:70-77), ksize=3."""
    g = _ensure_gray01(img)
    gx = conv3x3_reflect101(g, _SOBEL_X)
    gy = conv3x3_reflect101(g, _SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy)


def gradient_mse(hr: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    """MSE between HR/SR Sobel magnitudes (profiling_methods.py:79-85)."""
    return ((sobel_mag(hr) - sobel_mag(sr)) ** 2).mean()


def epi(hr: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    """Edge-preservation index: SR/HR gradient-energy ratio
    (profiling_methods.py:87-93)."""
    return (sobel_mag(sr).sum() + _EPS) / (sobel_mag(hr).sum() + _EPS)


# ------------------------------------------------------------ frequency stats
def hf_energy_ratio(hr: torch.Tensor, sr: torch.Tensor,
                    radius_frac: float = 0.6) -> torch.Tensor:
    """High-frequency spectral energy ratio SR/HR on 2-D grayscale images
    (profiling_methods.py:98-114)."""
    f_hr = torch.fft.fftshift(torch.fft.fft2(_f32(hr)))
    f_sr = torch.fft.fftshift(torch.fft.fft2(_f32(sr)))
    h, w = hr.shape
    yy = torch.arange(h, device=hr.device)[:, None] - h // 2
    xx = torch.arange(w, device=hr.device)[None, :] - w // 2
    r = torch.sqrt(yy.float() ** 2 + xx.float() ** 2)
    mask = r > (radius_frac * (r.max() + _EPS))
    num = (f_sr.abs() * mask).sum() + _EPS
    den = (f_hr.abs() * mask).sum() + _EPS
    return num / den


def _hist_density(x: torch.Tensor, bins: int) -> torch.Tensor:
    """np.histogram(range=(0, 255), density=True) parity: right-open bins
    except the last, which is closed."""
    edges = torch.as_tensor(np.linspace(0.0, 255.0, bins + 1, dtype=np.float32),
                            device=x.device)
    idx = torch.searchsorted(edges, x.reshape(-1).contiguous(), right=True) - 1
    idx = idx.clamp(0, bins - 1)
    # integer scatter-add: exact, and unlike bincount no host sync on CUDA
    counts = torch.zeros(bins, dtype=torch.int64, device=x.device)
    counts = counts.scatter_add_(0, idx, torch.ones_like(idx)).float()
    # density: counts / (n * bin_width); values never fall outside the range
    return counts / (counts.sum() * (255.0 / bins))


def _to_255(img: torch.Tensor) -> torch.Tensor:
    """The reference's dtype handling: floats are [0,1]*255, ints as they are."""
    if img.is_floating_point():
        return img.clamp(0.0, 1.0) * 255.0
    return img.float()


def kl_divergence(p_img: torch.Tensor, q_img: torch.Tensor,
                  bins: int = 256) -> torch.Tensor:
    """KL divergence of grayscale histograms (profiling_methods.py:116-137)."""
    p = _hist_density(_to_255(p_img), bins) + 1e-12
    q = _hist_density(_to_255(q_img), bins) + 1e-12
    return (p * torch.log(p / q)).sum()


def kl_divergence_color(p_rgb: torch.Tensor, q_rgb: torch.Tensor,
                        bins: int = 64) -> torch.Tensor:
    """Mean per-channel KL divergence for RGB (profiling_methods.py:139-164)."""
    p, q = _to_255(p_rgb), _to_255(q_rgb)
    total = torch.zeros((), dtype=torch.float32, device=p.device)
    for c in range(p.shape[-1]):
        ph = _hist_density(p[..., c], bins) + 1e-12
        qh = _hist_density(q[..., c], bins) + 1e-12
        total = total + (ph * torch.log(ph / qh)).sum()
    return total / p.shape[-1]
