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
kernel launches (``launch``), one per ``nlm_denoise`` call on a card.
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


# The kernel's geometry (csrc/nlm.cu): blocks of WARPS warps, each warp
# yielding COLS output columns; CONFIGS are its two instantiations, (rows a
# thread walks, warps that split the 168 offsets of one pixel run): one warp
# per run, and all eight warps of a block on one run.
WARPS, COLS = 8, 60
NO_SPLIT, SPLIT = CONFIGS = ((8, 1), (2, 8))


def grid(H: int, W: int, rows: int, split: int) -> tuple[int, int]:
    """(blocks across, blocks down) of a launch on an (H, W) image."""
    return -(-W // COLS), -(-H // (WARPS // split * rows))


def launch_config(H: int, W: int, n_sms: int) -> tuple[int, int]:
    """(rows, split) for an (H, W) image on a card with ``n_sms`` SMs: no
    split unless that grid has fewer blocks than SMs. It depends on the
    sizes alone, so a call's bits never change."""
    gx, gy = grid(H, W, *NO_SPLIT)
    return NO_SPLIT if gx * gy >= n_sms else SPLIT


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

    ``sigma`` and ``h`` are floats or 0-d tensors. For a CUDA image the
    call is one kernel launch and nothing else when both are float32 0-d
    tensors on its device (a float is copied there first): the kernel forms
    sigma^2 and 1 / max(h^2, 1e-12) itself, and nothing syncs with the
    host. Returns (H, W) float32.
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
    dev = img01.device
    sigma, h = _scalar(sigma, dev), _scalar(h, dev)
    if sigma.numel() != 1 or h.numel() != 1:
        raise ValueError(f"{name}: sigma and h must be scalars")
    y = torch.empty_like(img01)
    if y.numel() == 0:
        return y
    H, W = img01.shape
    launch(img01, sigma, h, y, *launch_config(
        H, W, torch.cuda.get_device_properties(dev).multi_processor_count))
    return y


def launch(x: torch.Tensor, sigma: torch.Tensor, h: torch.Tensor,
           y: torch.Tensor, rows: int, split: int) -> None:
    """One launch of ``csrc/nlm.cu`` at one of ``CONFIGS`` on the current
    stream: (H, W) float32 ``x`` into ``y``, float32 scalars ``sigma`` and
    ``h``, all contiguous on one CUDA device (``nlm_denoise`` checks that)."""
    H, W = x.shape
    lib = _build.load("nlm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("nlm", lib.nlm_denoise_launch(
        x.data_ptr(), sigma.data_ptr(), h.data_ptr(), y.data_ptr(), H, W,
        rows, split, stream))
    with _launch_lock:
        LAUNCHES["nlm_denoise"] += 1
