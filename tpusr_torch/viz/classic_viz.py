"""Classic-SR comparison panels (port of ``tpusr/viz/classic_viz.py``, the
reference's ``visualization_methods.py``), drawn by the port's figure
writer (``viz/figure.py``).

The same panels, names and arguments, on the summary schema of
``tpusr_torch.metrics.stats.build_metrics_summary``: time/memory 2x3,
PSNR/SSIM 2x2 with bootstrap-CI error bars, the 3-D speed-quality
trade-off (marker size ~ memory), MAE/RMSE grid, gradient/EPI grid,
HF-ratio/KL grid, the SR example grid, the SSIM similarity maps (computed
on ``device``, the first image's or the card's) and the weighted-ranking
bar with its per-metric contribution heat map.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpusr_torch.metrics.stats import (_derived_value, auto_metric_sets,
                                       rank_algorithms)
from tpusr_torch.viz.figure import figure, subplots


def _vals(summary, algs, key):
    return [summary.get(a, {}).get(key, np.nan) for a in algs]


def _bar(ax, algs, values, colors_map, title, ylabel=None, fmt="{:.4g}"):
    colors = [colors_map.get(a, "#888888") for a in algs]
    bars = ax.bar(algs, values, color=colors)
    ax.set_title(title)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.tick_params(axis="x", rotation=45)
    for b, v in zip(bars, values):
        if np.isfinite(v):
            ax.annotate(fmt.format(v), (b.get_x() + b.get_width() / 2, v),
                        ha="center", va="bottom", fontsize=7)


def _save(fig, outfile, dpi=150):
    if outfile is not None:
        os.makedirs(os.path.dirname(str(outfile)) or ".", exist_ok=True)
        fig.savefig(outfile, dpi=dpi)


def plot_time_memory_panels(metric_summary, algorithms_order, colors_map,
                            main_title, outfile, figsize=(18, 9)):
    """2x3: time mean/max/jitter, memory mean/max, time variance."""
    fig, axes = subplots(2, 3, figsize=figsize)
    panels = [
        ("time_mean", "Mean time (s)"), ("time_max", "Max time (s)"),
        ("time_jitter", "Time jitter (cv)"), ("memory_mean", "Mean memory (B)"),
        ("memory_max", "Max memory (B)"), ("time_var", "Time variance"),
    ]
    for ax, (key, title) in zip(axes.ravel(), panels):
        _bar(ax, algorithms_order, _vals(metric_summary, algorithms_order, key),
             colors_map, title)
    fig.suptitle(main_title)
    fig.tight_layout()
    _save(fig, outfile)


def plot_psnr_ssim_panels(metric_summary, algorithms_order, colors_map,
                          main_title, outfile, figsize=(18, 9)):
    """2x2 PSNR/SSIM mean (with bootstrap-CI error bars) and max."""
    fig, axes = subplots(2, 2, figsize=figsize)
    for row, met in enumerate(("psnr", "ssim")):
        means = _vals(metric_summary, algorithms_order, f"{met}_mean")
        lo = _vals(metric_summary, algorithms_order, f"{met}_ci_low")
        hi = _vals(metric_summary, algorithms_order, f"{met}_ci_high")
        err = [
            [m - l if np.isfinite(l) else 0 for m, l in zip(means, lo)],
            [h - m if np.isfinite(h) else 0 for m, h in zip(means, hi)],
        ]
        ax = axes[row, 0]
        colors = [colors_map.get(a, "#888") for a in algorithms_order]
        ax.bar(algorithms_order, means, yerr=err, capsize=3, color=colors)
        ax.set_title(f"{met.upper()} mean (95% bootstrap CI)")
        ax.tick_params(axis="x", rotation=45)
        _bar(axes[row, 1], algorithms_order,
             _vals(metric_summary, algorithms_order, f"{met}_max"),
             colors_map, f"{met.upper()} max")
    fig.suptitle(main_title)
    fig.tight_layout()
    _save(fig, outfile)


def plot_speed_quality_tradeoff_3d(metric_summary, algorithms, colors,
                                   results_dir=None, save=True, figsize=(10, 8),
                                   view=(22, -55), filename="speed_quality_3d.png"):
    """3-D scatter: time x PSNR x SSIM, marker size ~ memory mean."""
    fig = figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    mems = np.array(_vals(metric_summary, algorithms, "memory_mean"), float)
    finite = mems[np.isfinite(mems)]
    scale = finite.max() if finite.size and finite.max() > 0 else 1.0
    for a in algorithms:
        s = metric_summary.get(a, {})
        t = s.get("time_mean", np.nan)
        p = s.get("psnr_mean", np.nan)
        ss = s.get("ssim_mean", np.nan)
        if not (np.isfinite(t) and np.isfinite(p) and np.isfinite(ss)):
            continue  # degrade gracefully like the _vals() panels
        m = s.get("memory_mean", np.nan)
        size = 40 + 260 * (m / scale if np.isfinite(m) else 0.1)
        ax.scatter([t], [p], [ss], s=size, color=colors.get(a, "#888"), label=a)
        ax.text(t, p, ss, a, fontsize=8)
    ax.set_xlabel("time mean (s)")
    ax.set_ylabel("PSNR mean (dB)")
    ax.set_zlabel("SSIM mean")
    ax.view_init(*view)
    ax.set_title("Speed-quality trade-off (marker ~ memory)")
    out = (os.path.join(str(results_dir), filename)
           if (save and results_dir is not None) else None)
    _save(fig, out)


def plot_error_metrics_grid(metric_summary, algorithms, colors, results_dir=None,
                            figsize=(14, 8), filename="error_metrics.png"):
    """2x2 MAE/RMSE mean & max."""
    fig, axes = subplots(2, 2, figsize=figsize)
    for ax, key, title in zip(axes.ravel(),
                              ("mae_mean", "mae_max", "rmse_mean", "rmse_max"),
                              ("MAE mean", "MAE max", "RMSE mean", "RMSE max")):
        _bar(ax, algorithms, _vals(metric_summary, algorithms, key), colors, title)
    fig.tight_layout()
    _save(fig, os.path.join(str(results_dir), filename) if results_dir else None)


def plot_edge_metrics_grid(metric_summary, algorithms, colors, results_dir=None,
                           figsize=(12, 5), filename="edge_metrics.png"):
    """1x2 gradient-MSE and EPI (with the ideal-EPI=1 guide line)."""
    fig, axes = subplots(1, 2, figsize=figsize)
    _bar(axes[0], algorithms, _vals(metric_summary, algorithms, "grad_mse_mean"),
         colors, "Gradient MSE (mean)")
    _bar(axes[1], algorithms, _vals(metric_summary, algorithms, "epi_mean"),
         colors, "Edge Preservation Index (mean)")
    axes[1].axhline(1.0, color="k", ls="--", lw=1, label="ideal")
    axes[1].legend(fontsize=8)
    fig.tight_layout()
    _save(fig, os.path.join(str(results_dir), filename) if results_dir else None)


def plot_frequency_distribution_metrics_grid(metric_summary, algorithms, colors,
                                             results_dir=None, figsize=(16, 5),
                                             filename="freq_dist_metrics.png"):
    """1x3 HF-energy ratio (ideal 1), KL luma, KL color."""
    fig, axes = subplots(1, 3, figsize=figsize)
    _bar(axes[0], algorithms, _vals(metric_summary, algorithms, "hf_ratio_mean"),
         colors, "HF energy ratio (mean)")
    axes[0].axhline(1.0, color="k", ls="--", lw=1)
    _bar(axes[1], algorithms, _vals(metric_summary, algorithms, "kl_luma_mean"),
         colors, "KL divergence — luma")
    _bar(axes[2], algorithms, _vals(metric_summary, algorithms, "kl_color_mean"),
         colors, "KL divergence — color")
    fig.tight_layout()
    _save(fig, os.path.join(str(results_dir), filename) if results_dir else None)


def _to_display(img):
    """uint8 for display: a uint8 image as it is, else divided by its max
    where that exceeds 1.5, clipped to [0, 1], x 255 and truncated. A
    tensor stays on its device."""
    if isinstance(img, torch.Tensor):
        if img.dtype == torch.uint8:
            return img
        x = img if img.is_floating_point() else img.double()
        mx = x.max() if x.numel() else x.new_tensor(1.0)
        x = torch.where(mx > 1.5, x / mx, x)
        return (x.clamp(0, 1) * 255).to(torch.uint8)
    img = np.asarray(img)
    if img.dtype != np.uint8:
        mx = img.max() if img.size else 1.0
        img = (np.clip(img / mx if mx > 1.5 else img, 0, 1) * 255).astype(np.uint8)
    return img


def plot_and_save_super_resolution_example(vis, ibp_example, nlm_example,
                                           egi_example, freq_example, results_dir,
                                           filename="sr_examples.png"):
    """10-image grid: HR, LR, the 4 interpolations, IBP, NLM, EGI, FREQ."""
    hr, lr, bil, bic, area, lanc = vis
    tiles = [("HR", hr), ("LR", lr), ("bilinear", bil), ("bicubic", bic),
             ("area", area), ("lanczos", lanc), ("ibp", ibp_example[2]),
             ("nlm", nlm_example[1]), ("egi", egi_example[2]),
             ("freq", freq_example[1])]
    fig, axes = subplots(2, 5, figsize=(20, 8))
    for ax, (title, img) in zip(axes.ravel(), tiles):
        disp = _to_display(img)
        ax.imshow(disp, cmap="gray" if disp.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    _save(fig, os.path.join(str(results_dir), filename) if results_dir else None)


def plot_and_save_ssim_similarity_maps(vis, ibp_example, nlm_example, egi_example,
                                       freq_example, results_dir,
                                       filename="ssim_maps.png", device=None):
    """Per-algorithm SSIM maps vs HR (local SSIM heatmaps), computed on
    ``device`` (default: the HR image's, a numpy HR on the card)."""
    from tpusr_torch.device import resolve_device
    from tpusr_torch.metrics.image import _filter2_valid, rgb_to_gray

    hr0 = vis[0]
    dev = (hr0.device if isinstance(hr0, torch.Tensor) and device is None
           else resolve_device(device))

    def to_gray01(img):
        img = torch.as_tensor(np.asarray(img) if not isinstance(
            img, torch.Tensor) else img).to(dev, torch.float32)
        if img.dim() == 3:
            img = rgb_to_gray(img)
        return torch.where(img.max() > 1.5, img / 255.0, img)

    hr = to_gray01(hr0)

    def ssim_map(a, b):
        # local SSIM with uniform 7x7 window on grayscale
        win = np.full((7,), 1.0 / 7.0)
        aa = a[None, :, :, None]
        bb = b[None, :, :, None]
        ua = _filter2_valid(aa, win)
        ub = _filter2_valid(bb, win)
        uaa = _filter2_valid(aa * aa, win)
        ubb = _filter2_valid(bb * bb, win)
        uab = _filter2_valid(aa * bb, win)
        va, vb = uaa - ua * ua, ubb - ub * ub
        vab = uab - ua * ub
        c1, c2 = 0.01**2, 0.03**2
        s = ((2 * ua * ub + c1) * (2 * vab + c2)) / ((ua**2 + ub**2 + c1) * (va + vb + c2))
        return s[0, :, :, 0]

    candidates = [
        ("bilinear", to_gray01(vis[2])), ("bicubic", to_gray01(vis[3])),
        ("area", to_gray01(vis[4])), ("lanczos", to_gray01(vis[5])),
        ("ibp", to_gray01(ibp_example[2])), ("nlm", to_gray01(nlm_example[1])),
        ("egi", to_gray01(egi_example[2])), ("freq", to_gray01(freq_example[1])),
    ]
    fig, axes = subplots(2, 4, figsize=(18, 8))
    im = None
    for ax, (name, img) in zip(axes.ravel(), candidates):
        if img.shape != hr.shape:
            ax.axis("off")
            continue
        im = ax.imshow(ssim_map(hr, img), cmap="viridis", vmin=0, vmax=1)
        ax.set_title(f"SSIM map — {name}")
        ax.axis("off")
    if im is not None:  # all-mismatched shapes: save the blank grid
        fig.colorbar(im, ax=axes.ravel().tolist(), shrink=0.7)
    _save(fig, os.path.join(str(results_dir), filename) if results_dir else None)


def show_algorithm_ranking(metric_summary, maximize=None, minimize=None,
                           weights=None, results_dir=None,
                           filename="algorithm_ranking.png", dpi=150,
                           colors_map=None):
    """Weighted-composite ranking bar chart + per-metric contribution heatmap.
    Returns (ranked, scores) like the reference prints them."""
    ranked, scores, bounds = rank_algorithms(metric_summary, maximize, minimize,
                                             weights)
    if maximize is None and minimize is None:
        # rank_algorithms' own default, so that the heat map shows the
        # metrics the scores were built from
        maximize, minimize = auto_metric_sets(metric_summary)
    maximize = maximize or []
    minimize = minimize or []
    metrics_all = list(dict.fromkeys(list(maximize) + list(minimize)))
    if weights is None:
        weights = {m: 1.0 / max(1, len(metrics_all)) for m in metrics_all}

    algs = [a for a, _ in ranked]
    contrib = np.zeros((len(algs), len(metrics_all)))
    for i, a in enumerate(algs):
        for j, m in enumerate(metrics_all):
            val = _derived_value(metric_summary[a], m)
            lo, hi = bounds[m]
            if (np.isfinite(val) and np.isfinite(lo) and np.isfinite(hi)
                    and hi - lo != 0):
                norm = (val - lo) / (hi - lo) if m in maximize else (hi - val) / (hi - lo)
                contrib[i, j] = weights.get(m, 0.0) * float(np.clip(norm, 0, 1))

    fig, (ax1, ax2) = subplots(1, 2, figsize=(18, 7),
                               gridspec_kw={"width_ratios": [1, 1.4]})
    colors_map = colors_map or {}
    ax1.barh(algs[::-1], [scores[a] for a in algs[::-1]],
             color=[colors_map.get(a, "#4c72b0") for a in algs[::-1]])
    ax1.set_title("Composite ranking score")
    for i, a in enumerate(algs[::-1]):
        ax1.annotate(f"{scores[a]:.4f}", (scores[a], i), va="center", fontsize=8)

    im = ax2.imshow(contrib, cmap="viridis", aspect="auto")
    ax2.set_yticks(range(len(algs)), algs)
    ax2.set_xticks(range(len(metrics_all)), metrics_all, rotation=60, ha="right",
                   fontsize=7)
    ax2.set_title("Per-metric weighted contribution")
    fig.colorbar(im, ax=ax2, shrink=0.8)
    fig.tight_layout()
    _save(fig, os.path.join(str(results_dir), filename) if results_dir
          else None, dpi=dpi)
    return ranked, scores
