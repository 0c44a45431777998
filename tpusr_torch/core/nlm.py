"""Fast non-local means: K4 of the port, and its plain twin.

- ``nlm_denoise`` (K4) replaces the Pallas kernel
  ``tpusr/core/pallas_nlm.py::nlm_denoise_pallas``: one launch of the
  hand-written CUDA kernel of ``csrc/nlm.cu`` for a CUDA tensor, at any image
  size (the Pallas kernel's <= 512^2 gate was a TPU VMEM bound).
- ``nl_means_denoise`` is its plain twin, the scan formulation of
  ``tpusr/classic/algorithms.py::nl_means_denoise`` (skimage's ``fast_mode``):
  for every search offset a box-filtered squared difference on the
  reflect-padded image, weights ``exp(-max(d2 - 2 sigma^2, 0) / h^2)``.

A CPU tensor takes the twin; there is no other dispatch. ``LAUNCHES`` counts
kernel launches, one per call that reached the kernel.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from tpusr_torch.core import _build
from tpusr_torch.core.pad import pad_2d
from tpusr_torch.device import fp32_math

LAUNCHES = {"nlm_denoise": 0}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launch_lock:
        LAUNCHES["nlm_denoise"] = 0


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def nlm_params(sigma, h, device) -> torch.Tensor:
    """(2,) float32 [sigma^2, 1 / max(h^2, 1e-12)] on ``device``: the Pallas
    kernel's SMEM params (pallas_nlm.py:109-111), computed on the device."""
    sig2 = _scalar(sigma, device) ** 2
    inv_h2 = 1.0 / torch.clamp(_scalar(h, device) ** 2, min=1e-12)
    return torch.stack([sig2, inv_h2])


def nl_means_denoise(img01: torch.Tensor, sigma, h, patch_size: int = 5,
                     patch_distance: int = 6) -> torch.Tensor:
    """The plain twin of K4: fast NLM on an (H, W) [0, 1] grayscale image,
    one pass of plain tensor ops per search offset."""
    fp32_math()
    d, box = patch_distance, patch_size
    half_b = box // 2
    x = img01.float()
    H, W = x.shape
    pad = d + half_b
    xp = pad_2d(x, pad)
    a0 = pad - half_b
    x0_ext = xp[a0:a0 + H + box - 1, a0:a0 + W + box - 1]
    sig2 = _scalar(sigma, x.device) ** 2
    h2 = torch.clamp(_scalar(h, x.device) ** 2, min=1e-12)
    kv = torch.full((1, 1, box, 1), 1.0 / box, device=x.device)
    kh = kv.reshape(1, 1, 1, box)

    num, den = x.clone(), torch.ones_like(x)   # centre pixel, weight 1
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            if (dy, dx) == (0, 0):
                continue
            xs_ext = xp[a0 + dy:a0 + dy + H + box - 1,
                        a0 + dx:a0 + dx + W + box - 1]
            diff2 = ((x0_ext - xs_ext) ** 2)[None, None]
            d2 = F.conv2d(F.conv2d(diff2, kv), kh)[0, 0]     # box mean, VALID
            w = torch.exp(-torch.clamp(d2 - 2.0 * sig2, min=0.0) / h2)
            num = num + w * xp[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
            den = den + w
    return num / den


def nlm_denoise(img01: torch.Tensor, sigma, h) -> torch.Tensor:
    """Fast NLM on an (H, W) float32 [0, 1] grayscale image (K4), with the
    harness's 5x5 patches and 13x13 search window (compiled into nlm.cu).

    ``sigma`` and ``h`` are floats or 0-d tensors (on the image's device, so
    no host sync is needed). Returns (H, W) float32.
    """
    name = "nlm_denoise"
    if img01.dim() != 2:
        raise ValueError(f"{name}: img01 must be (H, W), got {tuple(img01.shape)}")
    if img01.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {img01.dtype}")
    if img01.device.type == "cpu":
        return nl_means_denoise(img01, sigma, h)
    if img01.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {img01.device}")
    if not img01.is_contiguous():
        raise ValueError(f"{name}: img01 must be contiguous")
    params = nlm_params(sigma, h, img01.device)
    y = torch.empty_like(img01)
    if y.numel() == 0:
        return y
    H, W = img01.shape
    lib = _build.load("nlm")
    stream = torch.cuda.current_stream(img01.device).cuda_stream
    _build.check("nlm", lib.nlm_denoise_launch(
        img01.data_ptr(), params.data_ptr(), y.data_ptr(), H, W, stream))
    with _launch_lock:
        LAUNCHES[name] += 1
    return y
