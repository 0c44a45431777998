"""Classic-SR comparison harness (port of ``tpusr/classic/harness.py``): all
eight algorithms with the reference's metric protocol and ranking weights.

Mirrors ``super_resolucion_clasica.ipynb`` cells 3-17:
- the interpolation family is scored in colour ([0, 1] PSNR/SSIM) plus seven
  more metrics;
- IBP/NLM/EGI/FREQ are scored on grayscale with data range 255 (NLM: the HR
  range), including the reference's quirk of scoring NLM's [0, 1] output
  against the [0, 255] HR (why NLM ranks last at ~2 dB);
- per-algorithm steady-state time and device memory;
- the summary and the cell-17 weighted ranking.

Everything runs on one device (the card unless ``device="cpu"``); the
metrics of one pair come back to the host in one transfer.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from tpusr_torch.classic import algorithms as A
from tpusr_torch.device import resolve_device
from tpusr_torch.metrics.image import (epi, gradient_mse, hf_energy_ratio,
                                       kl_divergence, kl_divergence_color, mae,
                                       rgb_to_gray, rmse, ssim_skimage)
from tpusr_torch.metrics.stats import build_metrics_summary, rank_algorithms

CLASSIC_ALGORITHMS = ["bilinear", "bicubic", "area", "lanczos", "ibp", "nlm",
                      "egi", "freq"]
INTERPOLATORS = {"bilinear": A.interpolate_bilinear,
                 "bicubic": A.interpolate_bicubic,
                 "area": A.interpolate_area,
                 "lanczos": A.interpolate_lanczos}

RANKING_WEIGHTS = {  # super_resolucion_clasica.ipynb cell 17
    "psnr_mean": 0.25, "ssim_mean": 0.25, "time_mean": 0.15, "memory_mean": 0.10,
    "mae_mean": 0.05, "rmse_mean": 0.05, "grad_mse_mean": 0.05,
    "kl_luma_mean": 0.05, "kl_color_mean": 0.05,
}
METRICS = ("psnr", "ssim", "mae", "rmse", "grad", "epi", "hf", "kl_luma",
           "kl_color")


def _psnr_range(a, b, data_range):
    d = a.float() - b.float()
    return 10.0 * torch.log10((data_range * data_range) / (d * d).mean())


def _gray_cv2_u8(img_u8):
    """cv2 RGB2GRAY on uint8 rounds to nearest; mirror that."""
    return torch.round(rgb_to_gray(img_u8.float()))


def _color_metrics(hr_u8, sr_u8):
    """Metric block for the interpolation family (colour, cell 7)."""
    hr_f, sr_f = hr_u8 / 255.0, sr_u8 / 255.0
    hr_g, sr_g = _gray_cv2_u8(hr_u8), _gray_cv2_u8(sr_u8)
    return {
        "psnr": _psnr_range(hr_f, sr_f, 1.0),
        "ssim": ssim_skimage(hr_f, sr_f, data_range=1.0, channel_axis=2),
        "mae": mae(hr_u8, sr_u8),
        "rmse": rmse(hr_u8, sr_u8),
        "grad": gradient_mse(hr_u8, sr_u8),
        "epi": epi(hr_u8, sr_u8),
        "hf": hf_energy_ratio(hr_g, sr_g),
        "kl_luma": kl_divergence(hr_g.int(), sr_g.int()),
        "kl_color": kl_divergence_color(hr_u8, sr_u8),
    }


def _gray_metrics(hr_g, sr_g, data_range):
    """Metric block for the other algorithms (grayscale, cell 7)."""
    return {
        "psnr": _psnr_range(hr_g, sr_g, data_range),
        "ssim": ssim_skimage(hr_g, sr_g, data_range=data_range),
        "mae": mae(hr_g, sr_g),
        "rmse": rmse(hr_g, sr_g),
        "grad": gradient_mse(hr_g, sr_g),
        "epi": epi(hr_g, sr_g),
        "hf": hf_energy_ratio(hr_g, sr_g),
        "kl_luma": kl_divergence(hr_g.int(), sr_g.int()),
        "kl_color": torch.full_like(hr_g[0, 0], float("nan")),
    }


def sr_images(hr_u8f: torch.Tensor, lr_u8f: torch.Tensor) -> dict:
    """The eight SR images of one HR/LR pair (float32 tensors holding uint8
    values) as the reference stores them: {algorithm: float32 tensor}. The
    interpolators' colour images are rounded, IBP and EGI floored (a uint8
    cast), FREQ max-normalised and floored; NLM's grayscale image stays a
    [0, 1] float, the reference's quirk."""
    out_hw = tuple(hr_u8f.shape[:2])
    images = {name: torch.round(fn(lr_u8f, out_hw)).clamp(0, 255)
              for name, fn in INTERPOLATORS.items()}
    hr_g, lr_g = _gray_cv2_u8(hr_u8f), _gray_cv2_u8(lr_u8f)
    images["ibp"] = torch.floor(A.back_projection(hr_g, lr_g, iterations=10))
    images["nlm"] = A.non_local_means(hr_g, lr_g / 255.0)
    images["egi"] = torch.floor(A.edge_guided_interpolation(hr_g, lr_g))
    freq = A.frequency_extrapolation(hr_g, lr_g)
    mx = freq.max()
    images["freq"] = torch.where(mx > 0, torch.floor(freq / mx * 255.0),
                                 torch.floor(freq))
    return images


def pair_metrics(hr_u8f: torch.Tensor, images: dict) -> dict:
    """The metric block of each stored SR image against the HR image:
    {algorithm: {metric: 0-d tensor}}. NLM is scored with the HR's grey
    range as its data range, the others with 255."""
    metrics = {name: _color_metrics(hr_u8f, images[name])
               for name in INTERPOLATORS}
    hr_g = _gray_cv2_u8(hr_u8f)
    span = hr_g.max() - hr_g.min()
    for name in ("ibp", "nlm", "egi", "freq"):
        dr = torch.where(span != 0, span, 255.0) if name == "nlm" else 255.0
        metrics[name] = _gray_metrics(hr_g, images[name], dr)
    return metrics


def _timed_calls(hr_g: torch.Tensor, lr_g: torch.Tensor,
                 lr_u8f: torch.Tensor) -> dict:
    """{algorithm: (fn, args)}: the call of each algorithm alone, as it is
    timed and its memory measured."""
    out_hw = tuple(hr_g.shape[:2])
    calls = {name: ((lambda lr, fn=fn: fn(lr, out_hw)), (lr_u8f,))
             for name, fn in INTERPOLATORS.items()}
    calls.update({
        "ibp": (lambda h, l: A.back_projection(h, l, 10), (hr_g, lr_g)),
        "nlm": (lambda h, l: A.non_local_means(h, l / 255.0), (hr_g, lr_g)),
        "egi": (A.edge_guided_interpolation, (hr_g, lr_g)),
        "freq": (A.frequency_extrapolation, (hr_g, lr_g)),
    })
    return calls


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _memory_bytes(fn, args, dev: torch.device) -> float:
    """Device bytes of one call: the peak it allocates over what was
    allocated before it, plus its arguments' bytes; the counterpart of XLA's
    arguments + outputs + temporaries. 0.0 off the card, as the JAX harness
    reports when XLA gives no memory analysis."""
    if dev.type != "cuda":
        return 0.0
    _sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before
    del out
    return float(peak + sum(a.numel() * a.element_size() for a in args))


def run_classic_comparison(hr_images, lr_images, time_repeats: int = 1,
                           progress=None, device=None):
    """Evaluate all 8 classic algorithms over HR/LR uint8 RGB pairs.

    Returns (summary, ranked, scores, per_image_stats) with the reference's
    summary schema and cell-17 ranking weights. Times are steady state: one
    warm-up call, then ``time_repeats`` calls between device barriers.
    Memory is measured once per algorithm and shape.
    """
    dev = resolve_device(device)
    stats = {k: defaultdict(list) for k in ("time", "memory") + METRICS}
    mem_cache: dict = {}

    with torch.inference_mode():
        for idx, (hr, lr) in enumerate(zip(hr_images, lr_images)):
            hr = np.asarray(hr)
            lr = np.asarray(lr)
            hr_d = torch.as_tensor(hr.astype(np.float32), device=dev)
            lr_d = torch.as_tensor(lr.astype(np.float32), device=dev)

            metrics = pair_metrics(hr_d, sr_images(hr_d, lr_d))
            flat = torch.stack([metrics[a][m].float() for a in metrics
                                for m in METRICS]).tolist()
            for i, (alg, mname) in enumerate((a, m) for a in metrics
                                             for m in METRICS):
                stats[mname][alg].append(flat[i])

            hr_g, lr_g = _gray_cv2_u8(hr_d), _gray_cv2_u8(lr_d)
            for alg, (fn, args) in _timed_calls(hr_g, lr_g, lr_d).items():
                fn(*args)                                  # warm-up
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(time_repeats):
                    fn(*args)
                _sync(dev)
                stats["time"][alg].append((time.perf_counter() - t0)
                                          / time_repeats)
                key = (alg, hr.shape, lr.shape)
                if key not in mem_cache:
                    mem_cache[key] = _memory_bytes(fn, args, dev)
                stats["memory"][alg].append(mem_cache[key])

            if progress is not None:
                progress(idx)

    summary = build_metrics_summary(
        stats["time"], stats["memory"], stats["psnr"], stats["ssim"],
        stats["mae"], stats["rmse"], stats["grad"], stats["epi"],
        stats["hf"], stats["kl_luma"], stats["kl_color"])
    ranked, scores, _ = rank_algorithms(
        summary,
        maximize=["psnr_mean", "ssim_mean"],
        minimize=["time_mean", "memory_mean", "mae_mean", "rmse_mean",
                  "grad_mse_mean", "kl_luma_mean", "kl_color_mean"],
        weights=RANKING_WEIGHTS)
    return summary, ranked, scores, stats
