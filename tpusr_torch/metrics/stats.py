"""Host-side statistics: bootstrap CIs, per-algorithm summaries, and ranking
(a copy of the numpy-only ``tpusr/metrics/stats.py``; importing it from there
would import JAX through ``tpusr/metrics/__init__.py``).

Behavioral parity with ``classic_super_resolution_algorithms/profiling_methods.py``:
- bootstrap_ci (:169-210): 1000-resample percentile CI of the mean, seeded.
- compute_summary_stats (:215-247) and build_metrics_summary (:249-332): the
  per-algorithm summary schema consumed by every comparison panel.
- rank_algorithms (:334-496): min-max normalized weighted composite with the
  same derived metrics (CI widths, |epi-1|, |hf-1|) and defaults.

These aggregate a handful of floats per algorithm, so host numpy is the right
tool; the per-image metrics themselves run on the device
(tpusr_torch.metrics.image).
"""

from __future__ import annotations

import numpy as np

# Metric direction defaults (profiling_methods.py:11-12)
MAXIMIZE_DEFAULT = ["psnr_mean", "ssim_mean"]
MINIMIZE_DEFAULT = ["time_mean", "memory_mean", "mae_mean", "rmse_mean"]


def bootstrap_ci(values, n_boot: int = 1000, ci: float = 0.95, seed: int = 42):
    """Percentile bootstrap CI of the mean. Vectorized; same rng stream semantics
    differ from the reference's per-resample loop, but the estimator is identical
    (1000 with-replacement resamples of the mean, seeded default_rng)."""
    values = np.asarray(values, dtype=float)
    if values.size < 2:
        return (np.nan, np.nan)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, values.size, size=(n_boot, values.size))
    means = values[idx].mean(axis=1)
    lo = (1.0 - ci) / 2.0 * 100.0
    hi = (1.0 + ci) / 2.0 * 100.0
    return (float(np.percentile(means, lo)), float(np.percentile(means, hi)))


def compute_summary_stats(values) -> dict:
    values = np.asarray(values, dtype=float)
    if values.size == 0:
        return {"mean": np.nan, "median": np.nan, "max": np.nan,
                "std": np.nan, "var": np.nan, "count": 0}
    return {
        "mean": float(np.mean(values)),
        "median": float(np.median(values)),
        "max": float(np.max(values)),
        "std": float(np.std(values, ddof=1)) if values.size > 1 else 0.0,
        "var": float(np.var(values, ddof=1)) if values.size > 1 else 0.0,
        "count": int(values.size),
    }


def build_metrics_summary(
    time_stats, memory_stats, psnr_stats, ssim_stats, mae_stats, rmse_stats,
    gradient_mse_stats, epi_stats, hf_energy_ratio_stats, kl_luma_stats, kl_color_stats,
) -> dict:
    """Per-algorithm summary dict with the reference's exact key schema."""
    tj, tv, mv = {}, {}, {}
    for alg in time_stats:
        t = np.asarray(time_stats.get(alg, []), dtype=float)
        if t.size > 1 and t.mean() > 0:
            tj[alg] = float(np.std(t, ddof=1) / t.mean())
            tv[alg] = float(np.var(t, ddof=1))
        else:
            tj[alg] = np.nan
            tv[alg] = np.nan
        m = np.asarray(memory_stats.get(alg, []), dtype=float)
        mv[alg] = float(np.var(m, ddof=1)) if m.size > 1 else np.nan

    psnr_ci = {alg: bootstrap_ci(v) for alg, v in psnr_stats.items()}
    ssim_ci = {alg: bootstrap_ci(v) for alg, v in ssim_stats.items()}

    summary = {}
    for alg in time_stats:
        s = lambda d: compute_summary_stats(d.get(alg, []))  # noqa: E731
        t_, m_, p_, ss_, ma_, r_, g_, e_, h_, kl_, kc_ = (
            s(time_stats), s(memory_stats), s(psnr_stats), s(ssim_stats),
            s(mae_stats), s(rmse_stats), s(gradient_mse_stats), s(epi_stats),
            s(hf_energy_ratio_stats), s(kl_luma_stats), s(kl_color_stats))
        summary[alg] = {
            "psnr_mean": p_["mean"], "psnr_var": p_["var"], "psnr_max": p_["max"],
            "psnr_ci_low": psnr_ci[alg][0], "psnr_ci_high": psnr_ci[alg][1],
            "ssim_mean": ss_["mean"], "ssim_var": ss_["var"], "ssim_max": ss_["max"],
            "ssim_ci_low": ssim_ci[alg][0], "ssim_ci_high": ssim_ci[alg][1],
            "time_mean": t_["mean"], "time_max": t_["max"],
            "time_jitter": tj[alg], "time_var": tv[alg],
            "memory_mean": m_["mean"], "memory_max": m_["max"], "memory_var": mv[alg],
            "mae_mean": ma_["mean"], "mae_max": ma_["max"],
            "rmse_mean": r_["mean"], "rmse_max": r_["max"],
            "grad_mse_mean": g_["mean"], "epi_mean": e_["mean"],
            "hf_ratio_mean": h_["mean"], "kl_luma_mean": kl_["mean"],
            "kl_color_mean": kc_["mean"],
        }
    return summary


def _derived_value(stats: dict, metric: str) -> float:
    if metric == "psnr_ci_width":
        lo, hi = stats.get("psnr_ci_low", np.nan), stats.get("psnr_ci_high", np.nan)
        return float(hi - lo) if np.isfinite(lo) and np.isfinite(hi) else np.nan
    if metric == "ssim_ci_width":
        lo, hi = stats.get("ssim_ci_low", np.nan), stats.get("ssim_ci_high", np.nan)
        return float(hi - lo) if np.isfinite(lo) and np.isfinite(hi) else np.nan
    if metric == "epi_dev":
        v = stats.get("epi_mean", np.nan)
        return float(abs(v - 1.0)) if np.isfinite(v) else np.nan
    if metric == "hf_ratio_dev":
        v = stats.get("hf_ratio_mean", np.nan)
        return float(abs(v - 1.0)) if np.isfinite(v) else np.nan
    return stats.get(metric, np.nan)


def auto_metric_sets(summary: dict):
    """(maximize, minimize) metric lists auto-derived from the summary's
    present keys — the default used by ``rank_algorithms`` when neither list
    is given (shared with the ranking viz so its contribution heatmap shows
    the same metrics the scores were built from)."""
    present = set()
    for st in summary.values():
        present.update(st.keys())
    maximize = [m for m in ["psnr_mean", "psnr_max", "ssim_mean", "ssim_max"]
                if m in present]
    minimize = [m for m in [
        "time_mean", "time_max", "time_jitter", "time_var",
        "memory_mean", "memory_max", "memory_var",
        "mae_mean", "mae_max", "rmse_mean", "rmse_max",
        "grad_mse_mean", "kl_luma_mean", "kl_color_mean",
        "psnr_var", "ssim_var",
    ] if m in present]
    if {"psnr_ci_low", "psnr_ci_high"} <= present:
        minimize.append("psnr_ci_width")
    if {"ssim_ci_low", "ssim_ci_high"} <= present:
        minimize.append("ssim_ci_width")
    if "epi_mean" in present:
        minimize.append("epi_dev")
    if "hf_ratio_mean" in present:
        minimize.append("hf_ratio_dev")
    return maximize, minimize


def rank_algorithms(summary: dict, maximize=None, minimize=None, weights=None):
    """Weighted min-max-normalized composite ranking (profiling_methods.py:334-496)."""
    if maximize is None and minimize is None:
        maximize, minimize = auto_metric_sets(summary)
    else:
        maximize = maximize or []
        minimize = minimize or []

    metrics_all = list(dict.fromkeys(list(maximize) + list(minimize)))

    bounds = {}
    for m in metrics_all:
        vals = np.array([_derived_value(st, m) for st in summary.values()], dtype=float)
        valid = vals[np.isfinite(vals)]
        bounds[m] = ((float(valid.min()), float(valid.max())) if valid.size
                     else (np.nan, np.nan))

    if weights is None:
        w = 1.0 / max(1, len(metrics_all))
        weights = {m: w for m in metrics_all}

    scores = {}
    for alg, stats in summary.items():
        total = 0.0
        for m in metrics_all:
            val = _derived_value(stats, m)
            lo, hi = bounds[m]
            if (not np.isfinite(val) or not np.isfinite(lo) or not np.isfinite(hi)
                    or hi - lo == 0):
                norm = 0.0
            else:
                norm = (val - lo) / (hi - lo) if m in maximize else (hi - val) / (hi - lo)
                norm = float(np.clip(norm, 0.0, 1.0))
            total += weights.get(m, 0.0) * norm
        scores[alg] = total

    ranked = sorted(scores.items(), key=lambda x: x[1], reverse=True)
    return ranked, scores, bounds
