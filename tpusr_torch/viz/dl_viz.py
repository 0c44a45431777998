"""Cross-model comparison panels (port of ``tpusr/viz/dl_viz.py``, the
reference's ``deep_lerning_visualizations.py``), drawn by the port's figure
writer (``viz/figure.py``): per-model train/val/eval loss-PSNR-SSIM bars,
train-vs-eval time, memory panels, confusion matrices, classification-report
panels (accuracy / macro-recall / macro-F1 / weighted-F1 + per-class heat
maps), image grids and prediction-confidence panels.

Inputs are the metric dicts of the port's trainers and of
``tpusr_torch.pipeline.defect_pipeline.run_defect_detection_comparison``.
``classification_report_dict`` is plain numpy, the JAX package's
arithmetic.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpusr_torch.viz.figure import subplots


def _save(fig, save_dir, filename):
    if save_dir is not None:
        os.makedirs(str(save_dir), exist_ok=True)
        fig.savefig(os.path.join(str(save_dir), filename), dpi=150)


def plot_sr_metrics(model_names, metrics_per_model, save_dir="DL_results",
                    filename="sr_metrics_panel.png"):
    """3x3: rows = loss/PSNR/SSIM, cols = train/val/eval. metrics_per_model is
    {model: {'train_loss':..,'val_loss':..,'eval_loss':..,'train_psnr':..,...}}."""
    rows = ("loss", "psnr", "ssim")
    cols = ("train", "val", "eval")
    fig, axes = subplots(3, 3, figsize=(16, 12))
    for i, met in enumerate(rows):
        for j, split in enumerate(cols):
            vals = [metrics_per_model.get(m, {}).get(f"{split}_{met}", np.nan)
                    for m in model_names]
            ax = axes[i, j]
            bars = ax.bar(model_names, vals)
            ax.set_title(f"{split} {met}")
            for b, v in zip(bars, vals):
                if np.isfinite(v):
                    ax.annotate(f"{v:.4g}", (b.get_x() + b.get_width() / 2, v),
                                ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    _save(fig, save_dir, filename)


def plot_sr_time(model_names, metrics_per_model, save_dir="DL_results",
                 filename="sr_time_panel.png"):
    """Train epoch time vs inference time per model."""
    fig, axes = subplots(1, 2, figsize=(14, 5))
    for ax, key, title in zip(
            axes, ("train_epoch_time_sec", "inference_time_sec"),
            ("Mean epoch time (s)", "Inference time (s)")):
        vals = [metrics_per_model.get(m, {}).get(key, np.nan) for m in model_names]
        bars = ax.bar(model_names, vals)
        ax.set_title(title)
        for b, v in zip(bars, vals):
            if np.isfinite(v):
                ax.annotate(f"{v:.3g}", (b.get_x() + b.get_width() / 2, v),
                            ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    _save(fig, save_dir, filename)


def plot_sr_memory(model_names, metrics_per_model, save_dir="DL_results",
                   filename="sr_memory_panel.png"):
    """2x2 device-memory panels: train mean/peak, inference mean/peak (MB)."""
    keys = (("train_mem_mean_mb", "Train memory mean (MB)"),
            ("train_mem_peak_mb", "Train memory peak (MB)"),
            ("inference_mem_mean_mb", "Inference memory mean (MB)"),
            ("inference_mem_peak_mb", "Inference memory peak (MB)"))
    fig, axes = subplots(2, 2, figsize=(14, 9))
    for ax, (key, title) in zip(axes.ravel(), keys):
        vals = [metrics_per_model.get(m, {}).get(key, np.nan) for m in model_names]
        ax.bar(model_names, vals)
        ax.set_title(title)
    fig.tight_layout()
    _save(fig, save_dir, filename)


def plot_confusion(ax, cm, classes, title):
    """Single confusion-matrix heatmap with count annotations
    (deep_lerning_visualizations.py:213-228), on a port ``Axes``."""
    cm = np.asarray(cm)
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(classes)), classes)
    ax.set_yticks(range(len(classes)), classes)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    thresh = cm.max() / 2.0 if cm.size else 0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    return im


def _per_class_stats(y_true, y_pred, num_classes):
    """precision/recall/f1/support per class, plain numpy."""
    out = []
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    for c in range(num_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        out.append({"precision": prec, "recall": rec, "f1": f1,
                    "support": int(np.sum(y_true == c))})
    return out


def classification_report_dict(y_true, y_pred, num_classes=None):
    """accuracy, macro recall/F1, weighted F1, per-class stats."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if num_classes is None:
        num_classes = int(max(y_true.max(), y_pred.max())) + 1
    per = _per_class_stats(y_true, y_pred, num_classes)
    supports = np.array([p["support"] for p in per], float)
    f1s = np.array([p["f1"] for p in per])
    recs = np.array([p["recall"] for p in per])
    wsum = supports.sum() if supports.sum() else 1.0
    return {
        "accuracy": float((y_true == y_pred).mean()),
        "macro_recall": float(recs.mean()),
        "macro_f1": float(f1s.mean()),
        "weighted_f1": float((f1s * supports).sum() / wsum),
        "per_class": per,
    }


def plot_classification_reports_panel(y_true, algo_names, preds_lists,
                                      class_names=None, save_dir="DL_results",
                                      prefix="cls_report"):
    """Per-SR-method classification comparison: confusion matrices, summary
    bars (accuracy / macro-recall / macro-F1 / weighted-F1) and per-class
    F1 & recall heatmaps (deep_lerning_visualizations.py:230-424)."""
    y_true = np.asarray(y_true)
    # size from labels AND predictions: a predicted class absent from the
    # label slice must not index out of the confusion matrix
    num_classes = int(max(int(y_true.max()),
                          *(int(np.asarray(p).max()) for p in preds_lists))) + 1
    if class_names is None:
        class_names = [str(c) for c in range(num_classes)]
    reports = {a: classification_report_dict(y_true, p, num_classes)
               for a, p in zip(algo_names, preds_lists)}

    # confusion matrices
    n = len(algo_names)
    fig, axes = subplots(1, n, figsize=(5 * n, 4.5), squeeze=False)
    for ax, a, preds in zip(axes[0], algo_names, preds_lists):
        cm = np.zeros((num_classes, num_classes), np.int64)
        for t, p in zip(y_true, np.asarray(preds)):
            cm[int(t), int(p)] += 1
        plot_confusion(ax, cm, class_names, f"{a} (acc={reports[a]['accuracy']:.3f})")
    fig.tight_layout()
    _save(fig, save_dir, f"{prefix}_confusions.png")

    # summary bars + per-class heatmaps
    fig, axes = subplots(2, 2, figsize=(14, 10))
    summary_keys = ("accuracy", "macro_recall", "macro_f1", "weighted_f1")
    ax = axes[0, 0]
    width = 0.8 / len(summary_keys)
    xs = np.arange(len(algo_names))
    for k, key in enumerate(summary_keys):
        ax.bar(xs + k * width, [reports[a][key] for a in algo_names], width,
               label=key)
    ax.set_xticks(xs + 0.4 - width / 2, algo_names, rotation=30)
    ax.set_ylim(0, 1.05)
    ax.legend(fontsize=8)
    ax.set_title("Classification summary per SR method")

    f1_mat = np.array([[reports[a]["per_class"][c]["f1"] for c in range(num_classes)]
                       for a in algo_names])
    rec_mat = np.array([[reports[a]["per_class"][c]["recall"] for c in range(num_classes)]
                        for a in algo_names])
    for ax, mat, title in ((axes[0, 1], f1_mat, "Per-class F1"),
                           (axes[1, 0], rec_mat, "Per-class recall")):
        im = ax.imshow(mat, cmap="viridis", vmin=0, vmax=1, aspect="auto")
        ax.set_xticks(range(num_classes), class_names)
        ax.set_yticks(range(len(algo_names)), algo_names)
        ax.set_title(title)
        for i in range(mat.shape[0]):
            for j in range(mat.shape[1]):
                ax.text(j, i, f"{mat[i, j]:.2f}", ha="center", va="center",
                        color="white" if mat[i, j] < 0.5 else "black", fontsize=8)
        fig.colorbar(im, ax=ax, shrink=0.8)
    axes[1, 1].axis("off")
    fig.tight_layout()
    _save(fig, save_dir, f"{prefix}_summary.png")
    return reports


def plot_4x3(images, titles=None, cmap="gray", save_dir=None,
             filename="image_grid.png"):
    """4x3 image grid (deep_lerning_visualizations.py:426-452); a tensor
    image is shown from its device."""
    fig, axes = subplots(4, 3, figsize=(12, 14))
    for k, ax in enumerate(axes.ravel()):
        if k < len(images):
            img = images[k]
            if isinstance(img, torch.Tensor):
                shown = img if img.dtype == torch.uint8 else img.clamp(0, 1)
            else:
                img = np.asarray(img)
                shown = np.clip(img, 0, 1) if img.dtype != np.uint8 else img
            ax.imshow(shown, cmap=cmap if img.ndim == 2 else None)
            if titles is not None and k < len(titles):
                ax.set_title(titles[k], fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    _save(fig, save_dir, filename)


def plot_confidence_panel(y, algo_names, label_lists, conf_lists,
                          save_dir="DL_results",
                          filename="sr_confidence_panel.png"):
    """Mean confidence (global / correct / wrong) + error rate per SR method
    (deep_lerning_visualizations.py:454-549)."""
    y = np.asarray(y)
    stats = []
    for preds, confs in zip(label_lists, conf_lists):
        preds = np.asarray(preds)
        confs = np.asarray(confs)
        ok = preds == y
        stats.append({
            "mean": confs.mean() if confs.size else np.nan,
            "correct": confs[ok].mean() if ok.any() else np.nan,
            "wrong": confs[~ok].mean() if (~ok).any() else np.nan,
            "error_rate": 1.0 - ok.mean() if ok.size else np.nan,
        })
    fig, axes = subplots(1, 2, figsize=(14, 5))
    xs = np.arange(len(algo_names))
    width = 0.25
    for k, key in enumerate(("mean", "correct", "wrong")):
        axes[0].bar(xs + k * width, [s[key] for s in stats], width, label=key)
    axes[0].set_xticks(xs + width, algo_names, rotation=30)
    axes[0].set_ylim(0, 1.05)
    axes[0].legend()
    axes[0].set_title("Mean prediction confidence")
    axes[1].bar(algo_names, [s["error_rate"] for s in stats], color="#c44e52")
    axes[1].set_title("Error rate")
    axes[1].tick_params(axis="x", rotation=30)
    fig.tight_layout()
    _save(fig, save_dir, filename)
    return stats
