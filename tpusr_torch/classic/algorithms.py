"""The eight classic SR algorithms (port of ``tpusr/classic/algorithms.py``).

Reference: the study's ``classic_super_resolution_algorithms/
classic_algorithms.py``. Resampling is two matrix products
(``tpusr_torch.core.resize``), IBP a loop over them, frequency extrapolation
``torch.fft`` in complex64, NLM K4 (``tpusr_torch.core.nlm``) and the
wavelet sigma estimator a db2 HH-subband MAD.

All functions take and return float32 tensors and read nothing back to the
host. Grayscale algorithms work in [0, 255] like the reference's uint8 path;
callers convert dtypes at the boundary.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusr_torch.core.nlm import nl_means_denoise, nlm_denoise
from tpusr_torch.core.pad import pad_2d
from tpusr_torch.core.resize import resize
from tpusr_torch.device import fp32_math
from tpusr_torch.metrics.image import conv3x3_reflect101

__all__ = ["interpolate_bilinear", "interpolate_bicubic", "interpolate_area",
           "interpolate_lanczos", "back_projection", "estimate_sigma",
           "nl_means_denoise", "non_local_means", "edge_guided_interpolation",
           "frequency_extrapolation"]


# ------------------------------------------------- interpolation family (1-4)
def interpolate_bilinear(lr_img, out_hw):
    """cv2.INTER_LINEAR upscale (classic_algorithms.py:7-9)."""
    return resize(lr_img, out_hw, "bilinear")


def interpolate_bicubic(lr_img, out_hw):
    """cv2.INTER_CUBIC upscale (classic_algorithms.py:11-13)."""
    return resize(lr_img, out_hw, "bicubic")


def interpolate_area(lr_img, out_hw):
    """cv2.INTER_AREA upscale (classic_algorithms.py:15-17)."""
    return resize(lr_img, out_hw, "area")


def interpolate_lanczos(lr_img, out_hw):
    """cv2.INTER_LANCZOS4 upscale (classic_algorithms.py:19-21)."""
    return resize(lr_img, out_hw, "lanczos4")


# --------------------------------------------------- iterative back-projection
def back_projection(hr_image, lr_image, iterations: int = 10):
    """Iterative back-projection on grayscale [0, 255]
    (classic_algorithms.py:23-42): each iteration bilinear-downscales the HR
    estimate, takes the residual against the observed LR, bilinear-upscales
    it and adds it; the result is clipped to [0, 255]."""
    hr_hw, lr_hw = hr_image.shape[:2], lr_image.shape[:2]
    lr = lr_image.float()
    hr = hr_image.float()
    for _ in range(iterations):
        down = resize(hr, lr_hw, "bilinear")
        hr = hr + resize(lr - down, hr_hw, "bilinear")
    return hr.clamp(0.0, 255.0)


# ------------------------------------------------------------ non-local means
# db2 decomposition high-pass filter (Daubechies-2), pywt convention, reversed
# because pywt convolves and conv1d correlates
_DB2_HI = np.array(
    [-0.48296291314469025, 0.836516303737469, -0.22414386804185735,
     -0.12940952255092145], dtype=np.float64)[::-1].copy()


def _dwt_rows_hi(x: torch.Tensor) -> torch.Tensor:
    """One-level 1-D high-pass DWT of each row of a 2-D tensor, pywt
    'symmetric' mode: full correlation, then the odd samples."""
    taps = _DB2_HI.shape[0]
    xp = pad_2d(x, taps - 1, "symmetric", dims=(-1,))
    k = torch.as_tensor(_DB2_HI.astype(np.float32), device=x.device)
    y = F.conv1d(xp[:, None, :], k[None, None, :])[:, 0, :]
    return y[:, 1::2]


def _dwt2_hh(img: torch.Tensor) -> torch.Tensor:
    """HH (diagonal detail) subband of a single-level db2 DWT."""
    h = _dwt_rows_hi(img)           # high-pass along the columns axis
    return _dwt_rows_hi(h.T.contiguous()).T


def estimate_sigma(img01: torch.Tensor) -> torch.Tensor:
    """Wavelet-domain noise-sigma estimator
    (skimage.restoration.estimate_sigma): median(|HH|) / norm.ppf(0.75),
    zeros excluded. Returns a 0-d tensor on the image's device; the median
    is taken by a sort, with no host sync."""
    fp32_math()
    a = _dwt2_hh(img01.float()).abs().reshape(-1)
    nz = a > 0
    n = nz.sum()
    # the two middle order statistics of the non-zeros: zeros sort last
    sorted_a = torch.sort(torch.where(nz, a, torch.inf)).values
    mid = torch.stack([(n - 1) // 2, n // 2]).clamp(0, a.numel() - 1)
    pair = sorted_a.index_select(0, mid)    # a tensor index: no .item()
    med = 0.5 * (pair[0] + pair[1])
    med = torch.where(n > 0, med, torch.zeros_like(med))
    return med / 0.6744897501960817


def non_local_means(hr_g: torch.Tensor, lr_g01: torch.Tensor) -> torch.Tensor:
    """NLM-denoise the LR grayscale, then Lanczos-upscale it to the HR size
    (classic_algorithms.py:44-59). ``lr_g01`` is the LR image in [0, 1]
    (img_as_float); the output stays in [0, 1] like the reference's. The
    denoiser is K4 for a CUDA tensor, at any size, and its plain twin for a
    CPU tensor."""
    sigma = estimate_sigma(lr_g01)
    den = nlm_denoise(lr_g01.float().contiguous(), sigma, 1.15 * sigma)
    return resize(den, hr_g.shape[:2], "lanczos4")


# ------------------------------------------------- edge-guided interpolation
_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


def edge_guided_interpolation(ground_truth, image):
    """Bilinear upscale + 0.3 x the upscaled Sobel magnitude
    (classic_algorithms.py:61-82), grayscale [0, 255]. The reference
    upscales the uint8 image (rounded) but the float64 edge map."""
    img = image.float()
    edges = torch.hypot(conv3x3_reflect101(img, _SOBEL_X),
                        conv3x3_reflect101(img, _SOBEL_X.T))
    out_hw = ground_truth.shape[:2]
    upscaled = torch.round(resize(img, out_hw, "bilinear")).clamp(0, 255)
    up_edges = resize(edges, out_hw, "bilinear")
    return (upscaled + 0.3 * up_edges).clamp(0.0, 255.0)


# --------------------------------------------------- frequency extrapolation
def frequency_extrapolation(ground_truth, image):
    """Zero-pad the centred LR spectrum into the HR shape and invert
    (classic_algorithms.py:84-108); complex64 FFTs."""
    fshift = torch.fft.fftshift(torch.fft.fft2(image.float()))
    rows, cols = image.shape
    pad_rows, pad_cols = ground_truth.shape[:2]
    r0 = pad_rows // 2 - rows // 2
    c0 = pad_cols // 2 - cols // 2
    f_padded = torch.zeros((pad_rows, pad_cols), dtype=fshift.dtype,
                           device=fshift.device)
    f_padded[r0:r0 + rows, c0:c0 + cols] = fshift
    return torch.fft.ifft2(torch.fft.ifftshift(f_padded)).abs()
