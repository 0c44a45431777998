"""Dataset-quality EDA (port of ``tpusr/data/eda.py``, the reference's
``data/EDA.ipynb``), with every per-pair statistic a tensor op on the
pair's device (the card unless the caller passes ``device="cpu"``).

Per LR/HR pair: LPIPS (with provisioned weights), PSNR, SSIM, GLCM
contrast/homogeneity/correlation, RMS noise, Laplacian variance, DCT
blocking score, colour noise, Canny-ring ringing, saturation and brightness
means, per-channel skew/kurtosis and the Sobel edge-energy difference; and
the global accumulators ``gd`` (mean FFT spectra, HR gradient energy, LR
GLCM, saturation histograms, LR colour noise). The functions, the row keys
and their order are the JAX package's. The OpenCV calls are the port's own
ops (``data/_cv_ops.py``), equal to cv2's on integer results.

``run_eda_pipeline`` writes ``eda_metrics.csv`` and ``eda_summary.csv``
(pandas' ``describe()`` columns, written with the ``csv`` module), the JAX
pipeline's figures through the port's figure writer (``viz/figure.py``):
``advanced_global_panel.png``, the six figures of the metrics table and,
for the best/worst scenarios it picks as the JAX pipeline does,
``LPIPS_Scenarios/{best,worst}_scenarios/<file>`` and ``advanced_<file>``.
It returns the rows and ``gd``, with the pick in ``gd["scenarios"]``. The
maps of the figures (spectra, Sobel magnitude, GLCM, noise map, the
difference map and its JET colours) are computed on the EDA's device; the
table's statistics are numpy on the host, as pandas computes them
(``correlation``: pairwise-complete Pearson).
"""

from __future__ import annotations

import csv
import math
import os
import pickle
import time

import numpy as np
import torch

from tpusr_torch.data import _cv_ops as cv
from tpusr_torch.data.loading import imread_rgb_u8
from tpusr_torch.device import resolve_device
from tpusr_torch.metrics.image import ssim_skimage

_INTERP = {"INTER_LINEAR": "bilinear", "INTER_CUBIC": "bicubic",
           "INTER_AREA": "area", "INTER_LANCZOS4": "lanczos4"}
SUMMARY_COLUMNS = ("mean", "std", "25%", "50%", "75%")


# ------------------------------------------------------------------ pair I/O
def iter_pairs(lr_base, hr_base):
    """Matching relative paths present in both trees (EDA cell 2)."""
    exts = (".png", ".jpg", ".jpeg")

    def walk(base):
        rels = set()
        for root, _, files in os.walk(base):
            for f in files:
                if f.lower().endswith(exts):
                    rels.add(os.path.relpath(os.path.join(root, f), base))
        return rels

    common = sorted(walk(lr_base) & walk(hr_base))
    if not common:
        raise ValueError("No matching LR/HR image pairs were found.")
    return [(r, r) for r in common]


def _read_bgr(path: str, device) -> torch.Tensor:
    return torch.from_numpy(imread_rgb_u8(path)[..., ::-1].copy()).to(device)


def load_and_align(lr_path, hr_path, interp_map=None, device=None):
    """Load the BGR uint8 pair onto ``device``; upscale LR to the HR size
    with the recorded interpolation (``INTER_CUBIC`` when none is
    recorded or the name is not one of the four)."""
    dev = resolve_device(device)
    try:
        lr, hr = _read_bgr(lr_path, dev), _read_bgr(hr_path, dev)
    except ValueError as e:
        raise ValueError(f"Failed reading {lr_path} or {hr_path} ({e})") from None
    if lr.shape[:2] != hr.shape[:2]:
        method = "bicubic"
        if interp_map:
            method = _INTERP.get(interp_map.get(os.path.basename(lr_path)),
                                 "bicubic")
        lr = cv.resize_u8(lr, hr.shape[:2], method)
    return lr, hr


# ------------------------------------------------------------------- metrics
def lpips_score(lr_bgr, hr_bgr, net=None):
    """LPIPS(alex) of the pair on ``net``'s device (a
    ``tpusr_torch.metrics.lpips.LPIPSAlex``), or None without one: the
    LPIPS column and the scenario pick then fall back as in JAX."""
    if net is None:
        return None
    from tpusr_torch.metrics.lpips import lpips_alex_from_uint8_rgb

    return lpips_alex_from_uint8_rgb(net, lr_bgr.flip(-1), hr_bgr.flip(-1))


def psnr_metric(lr_img, hr_img):
    mse = float(((hr_img.double() - lr_img.double()) ** 2).mean())
    return float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else np.inf


def ssim_metric(lr_img, hr_img):
    return float(ssim_skimage(hr_img.float(), lr_img.float(), data_range=255,
                              channel_axis=2))


def glcm_matrix(gray_u8: torch.Tensor, levels: int = 256) -> torch.Tensor:
    """Symmetric, normalized co-occurrence matrix at offset (0, 1)
    (graycomatrix semantics for distances=[1], angles=[0]), float64."""
    a = gray_u8[:, :-1].reshape(-1).long()
    b = gray_u8[:, 1:].reshape(-1).long()
    m = torch.bincount(a * levels + b, minlength=levels * levels).double()
    m = m.reshape(levels, levels)
    m = m + m.T
    s = m.sum()
    return m / s if float(s) else m


def glcm_features(gray_u8, angles=None, levels=64, multi_angle=False):
    """contrast / homogeneity / correlation (graycoprops formulas), averaged
    over angles. Angles beyond 0 use the corresponding pixel offsets."""
    if angles is None:
        angles = (0, np.pi / 4, np.pi / 2, 3 * np.pi / 4) if multi_angle else (0,)
    if int(gray_u8.max()) == 0:
        norm = torch.zeros_like(gray_u8)
    else:
        # numpy's float32 arithmetic, then a truncating cast
        norm = ((gray_u8.float() / 255.0) * (levels - 1)).to(torch.uint8)

    offsets = {0: (0, 1), np.pi / 4: (-1, 1), np.pi / 2: (-1, 0),
               3 * np.pi / 4: (-1, -1)}
    i_idx = torch.arange(levels, dtype=torch.float64, device=gray_u8.device)
    ii, jj = torch.meshgrid(i_idx, i_idx, indexing="ij")
    cons, homs, cors = [], [], []
    for ang in angles:
        dy, dx = offsets.get(ang, (0, 1))
        h, w = norm.shape
        y0, y1 = max(0, -dy), min(h, h - dy)
        x0, x1 = max(0, -dx), min(w, w - dx)
        a = norm[y0:y1, x0:x1].reshape(-1).long()
        b = norm[y0 + dy:y1 + dy, x0 + dx:x1 + dx].reshape(-1).long()
        m = torch.bincount(a * levels + b, minlength=levels * levels).double()
        m = m.reshape(levels, levels)
        m = m + m.T
        s = float(m.sum())
        p = m / s if s else m
        cons.append(float((p * (ii - jj) ** 2).sum()))
        homs.append(float((p / (1.0 + (ii - jj) ** 2)).sum()))
        mu_i = (p * ii).sum()
        mu_j = (p * jj).sum()
        sd_i = float(torch.sqrt((p * (ii - mu_i) ** 2).sum()))
        sd_j = float(torch.sqrt((p * (jj - mu_j) ** 2).sum()))
        if sd_i > 1e-15 and sd_j > 1e-15:
            cors.append(float((p * (ii - mu_i) * (jj - mu_j)).sum())
                        / (sd_i * sd_j))
        else:
            cors.append(1.0)
    return {"glcm_contrast": float(np.mean(cons)),
            "glcm_homogeneity": float(np.mean(homs)),
            "glcm_correlation": float(np.mean(cors))}


def rms_noise(gray_u8):
    blurred = cv.gaussian_blur_u8(gray_u8, 3)
    diff = gray_u8.double() - blurred.double()
    return float(torch.sqrt((diff**2).mean()))


def laplacian_variance(gray_u8):
    return float(cv.laplacian(gray_u8).var(unbiased=False))


def _moments(x: torch.Tensor) -> tuple[float, float, float, float]:
    """mean, std (ddof 0), skew and Fisher kurtosis (both biased, as
    ``scipy.stats.skew``/``kurtosis``) of a flat float64 tensor."""
    mean = x.mean()
    d = x - mean
    m2 = (d * d).mean()
    m3 = (d**3).mean()
    m4 = (d**4).mean()
    m2f = float(m2)
    # scipy's test for a constant sample: nan, not a division by ~0
    zero = m2f <= (np.finfo(np.float64).resolution * float(mean)) ** 2
    skew = math.nan if zero else float(m3 / m2**1.5)
    kurt = math.nan if zero else float(m4 / m2**2) - 3.0
    return float(mean), math.sqrt(m2f), skew, kurt


def feature_distribution(img_bgr, hsv):
    """``hsv`` is the (S, V) pair of ``_cv_ops.bgr2hsv_sv``."""
    out = {}
    for idx in range(img_bgr.shape[-1]):
        mean, std, skew, kurt = _moments(img_bgr[..., idx].reshape(-1).double())
        out[f"ch{idx}_mean"] = mean
        out[f"ch{idx}_std"] = std
        out[f"ch{idx}_skew"] = skew
        out[f"ch{idx}_kurt"] = kurt
    s, v = hsv
    out["saturation_mean"] = float(s.double().mean())
    out["brightness_mean"] = float(v.double().mean())
    return out


def detect_artifacts(img_bgr, gray_u8):
    dct = cv.dct2(gray_u8.float())
    blocking = float((dct[7::8, :].abs().mean() + dct[:, 7::8].abs().mean()) / 2)
    blur = cv.gaussian_blur_u8(img_bgr, 5)
    color_noise = float((img_bgr.double() - blur.double()).abs().mean())
    edges = cv.canny(gray_u8, 100, 200)
    dilated = cv.dilate(edges, 5)
    ring_region = (dilated & ~edges).bool()
    ringing = (float(gray_u8[ring_region].double().std(unbiased=False))
               if bool(ring_region.any()) else 0.0)
    return {"blocking_score": blocking, "color_noise": color_noise,
            "ringing_artifact": ringing}


_SOBEL_H = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float64) / 4.0


def sobel_energy(gray_u8):
    """skimage.filters.sobel-style normalized gradient magnitude mean."""
    g = gray_u8.double() / 255.0
    sh = cv.correlate(g, _SOBEL_H)
    sv = cv.correlate(g, _SOBEL_H.T)
    return float(torch.sqrt(sh**2 + sv**2).mean())


def _area_resize_f64(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``cv2.resize(x, ..., INTER_AREA)`` of a float64 map, with
    ``core/resize.py``'s INTER_AREA taps."""
    from tpusr_torch.core.resize import resize_weights

    wv = torch.from_numpy(resize_weights(x.shape[0], out_hw[0], "area")).to(
        x.device, torch.float64)
    wh = torch.from_numpy(resize_weights(x.shape[1], out_hw[1], "area")).to(
        x.device, torch.float64)
    return wv @ x @ wh.T


def _sat_bins() -> np.ndarray:
    return np.linspace(0, 256, 51)


def _histogram_u8(plane: torch.Tensor, bins: np.ndarray) -> np.ndarray:
    """``np.histogram(plane, bins)`` of a uint8 plane: a 256-bin count on
    the device, folded into ``bins`` on the host."""
    counts = torch.bincount(plane.reshape(-1).long(), minlength=256).cpu().numpy()
    idx = np.clip(np.searchsorted(bins, np.arange(256), side="right") - 1,
                  0, len(bins) - 2)
    return np.bincount(idx, weights=counts, minlength=len(bins) - 1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ----------------------------------------------------------------- pipeline
def collect_metrics(lr_dir, hr_dir, glcm_multi_angle=False, glcm_levels=64,
                    interp_map=None, limit=None, progress=None, lpips_net=None,
                    device=None, timings=None):
    """The rows and the global accumulators ``gd`` (numpy arrays, as the
    JAX package's), computed on ``device``. ``lpips_net`` is an
    ``LPIPSAlex`` (or None: no LPIPS); ``timings``, a dict, gets each pair's
    ``decode``, ``lpips`` and ``rest`` milliseconds (the device synchronised
    at each boundary)."""
    dev = resolve_device(device)
    rows = []
    sat_bins = _sat_bins()
    gd = {"count": 0, "lr_fft_sum": None, "hr_fft_sum": None,
          "grad_hr_sum": None, "glcm_sum": None,
          "sat_lr_counts": np.zeros(50), "sat_hr_counts": np.zeros(50),
          "sat_bins": sat_bins, "noise_means_lr": []}

    pairs = iter_pairs(lr_dir, hr_dir)
    if limit:
        pairs = pairs[:limit]
    for lf, hf in pairs:
        t0 = time.perf_counter()
        lr_img, hr_img = load_and_align(os.path.join(lr_dir, lf),
                                        os.path.join(hr_dir, hf), interp_map,
                                        device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        lpips = lpips_score(lr_img, hr_img, lpips_net)
        t2 = time.perf_counter()
        gray_lr = cv.bgr2gray(lr_img)
        gray_hr = cv.bgr2gray(hr_img)
        hsv_lr = cv.bgr2hsv_sv(lr_img)
        hsv_hr = cv.bgr2hsv_sv(hr_img)

        glcm = glcm_features(gray_lr, levels=glcm_levels,
                             multi_angle=glcm_multi_angle)
        fd_lr = feature_distribution(lr_img, hsv_lr)
        fd_hr = feature_distribution(hr_img, hsv_hr)
        art_lr = detect_artifacts(lr_img, gray_lr)
        art_hr = detect_artifacts(hr_img, gray_hr)

        row = {
            "filename": lf.replace("\\", "/"),
            "lpips": lpips,
            "psnr": psnr_metric(lr_img, hr_img),
            "ssim": ssim_metric(lr_img, hr_img),
            **glcm,
            "rms_noise_lr": rms_noise(gray_lr), "rms_noise_hr": rms_noise(gray_hr),
            "lap_var_lr": laplacian_variance(gray_lr),
            "lap_var_hr": laplacian_variance(gray_hr),
            "blocking_lr": art_lr["blocking_score"],
            "blocking_hr": art_hr["blocking_score"],
            "color_noise_lr": art_lr["color_noise"],
            "color_noise_hr": art_hr["color_noise"],
            "ringing_lr": art_lr["ringing_artifact"],
            "ringing_hr": art_hr["ringing_artifact"],
            "saturation_mean_lr": fd_lr["saturation_mean"],
            "saturation_mean_hr": fd_hr["saturation_mean"],
            "brightness_mean_lr": fd_lr["brightness_mean"],
            "brightness_mean_hr": fd_hr["brightness_mean"],
            "edge_diff": sobel_energy(gray_hr) - sobel_energy(gray_lr),
        }
        for c in range(3):
            for stat in ("skew", "kurt"):
                row[f"ch{c}_{stat}_lr"] = fd_lr[f"ch{c}_{stat}"]
                row[f"ch{c}_{stat}_hr"] = fd_hr[f"ch{c}_{stat}"]
        rows.append(row)

        # global accumulators
        lr_fft = torch.fft.fftshift(torch.fft.fft2(gray_lr.double())).abs()
        hr_fft = torch.fft.fftshift(torch.fft.fft2(gray_hr.double())).abs()
        grad = torch.sqrt(cv.sobel5(gray_hr, 1, 0) ** 2
                          + cv.sobel5(gray_hr, 0, 1) ** 2)
        glcm_full = glcm_matrix(gray_lr, 256)
        if gd["lr_fft_sum"] is None:
            gd["lr_fft_sum"], gd["hr_fft_sum"] = lr_fft, hr_fft
            gd["grad_hr_sum"], gd["glcm_sum"] = grad, glcm_full
        else:
            # mixed-resolution datasets: the first pair's shape is the grid
            if grad.shape != gd["grad_hr_sum"].shape:
                lr_fft = _area_resize_f64(lr_fft, gd["lr_fft_sum"].shape)
                hr_fft = _area_resize_f64(hr_fft, gd["hr_fft_sum"].shape)
                grad = _area_resize_f64(grad, gd["grad_hr_sum"].shape)
            gd["lr_fft_sum"] = gd["lr_fft_sum"] + lr_fft
            gd["hr_fft_sum"] = gd["hr_fft_sum"] + hr_fft
            gd["grad_hr_sum"] = gd["grad_hr_sum"] + grad
            gd["glcm_sum"] = gd["glcm_sum"] + glcm_full
        gd["sat_lr_counts"] += _histogram_u8(hsv_lr[0], sat_bins)
        gd["sat_hr_counts"] += _histogram_u8(hsv_hr[0], sat_bins)
        gd["noise_means_lr"].append(art_lr["color_noise"])
        gd["count"] += 1
        _sync(dev)
        if timings is not None:
            t3 = time.perf_counter()
            for key, ms in (("decode", t1 - t0), ("lpips", t2 - t1),
                            ("rest", t3 - t2)):
                timings.setdefault(key, []).append(ms * 1e3)
        if progress:
            progress(gd["count"])
    # numpy, as the JAX package's; the device copies draw the global panel
    gd["on_device"] = {}
    for key in ("lr_fft_sum", "hr_fft_sum", "grad_hr_sum", "glcm_sum"):
        if gd[key] is not None:
            gd["on_device"][key] = gd[key]
            gd[key] = gd[key].cpu().numpy()
    return rows, gd


def _numeric_columns(rows: list[dict]) -> list[str]:
    """The columns pandas' ``select_dtypes(include=number)`` keeps: every
    column but ``filename``, and ``lpips`` only where it holds a value."""
    cols = [k for k in rows[0] if k != "filename"]
    if all(r["lpips"] is None for r in rows):
        cols.remove("lpips")
    return cols


def _column(rows: list[dict], key: str) -> np.ndarray:
    return np.array([math.nan if r[key] is None else r[key] for r in rows],
                    np.float64)


def summary(rows: list[dict]) -> dict[str, dict[str, float]]:
    """pandas' ``df.describe().T[["mean", "std", "25%", "50%", "75%"]]`` of
    the numeric columns: NaN skipped, std with ddof 1, linear quantiles."""
    out = {}
    for key in _numeric_columns(rows):
        x = _column(rows, key)
        x = x[~np.isnan(x)]
        if len(x) == 0:
            out[key] = dict.fromkeys(SUMMARY_COLUMNS, math.nan)
            continue
        with np.errstate(invalid="ignore"):
            std = float(np.std(x, ddof=1)) if len(x) > 1 else math.nan
            q = np.quantile(x, (0.25, 0.5, 0.75))
        out[key] = {"mean": float(np.mean(x)), "std": std,
                    "25%": float(q[0]), "50%": float(q[1]), "75%": float(q[2])}
    return out


def _csv_value(v) -> str:
    """A cell as pandas' ``to_csv`` writes it: NaN and None empty."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def write_metrics_csv(rows: list[dict], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(rows[0]))
        for r in rows:
            w.writerow([_csv_value(v) for v in r.values()])


def write_summary_csv(summ: dict, path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", *SUMMARY_COLUMNS])
        for key, stats in summ.items():
            w.writerow([key, *(_csv_value(stats[c]) for c in SUMMARY_COLUMNS)])


def pick_scenarios(rows: list[dict], top_k_examples: int = 1) -> dict:
    """Best and worst pairs by LPIPS (lower is better) where any pair has
    one, else by PSNR (higher is better), as the JAX pipeline picks them
    (NaN sorts last)."""
    key = "lpips" if any(r["lpips"] is not None for r in rows) else "psnr"
    x = _column(rows, key)
    order = sorted(range(len(rows)),
                   key=lambda i: (math.isnan(x[i]), x[i] if not math.isnan(x[i])
                                  else 0.0))
    head = [rows[i]["filename"] for i in order[:top_k_examples]]
    tail = [rows[i]["filename"] for i in order[-top_k_examples:]]
    if key == "lpips":
        return {"key": key, "best": head, "worst": tail}
    return {"key": key, "best": tail, "worst": head}


def global_panel_lines(gd: dict) -> list[str]:
    """One line for each panel of the JAX pipeline's global figure."""
    n = max(1, gd["count"])
    lines = []
    for key, name, log in (("lr_fft_sum", "mean LR spectrum", True),
                           ("hr_fft_sum", "mean HR spectrum", True),
                           ("grad_hr_sum", "mean HR gradient magnitude", False),
                           ("glcm_sum", "mean LR GLCM", True)):
        m = gd[key] / n
        m = np.log1p(m) if log else m
        lines.append(f"{name}{' (log)' if log else ''}: shape {m.shape}, "
                     f"mean {m.mean():.6g}, max {m.max():.6g}")
    centers = (gd["sat_bins"][:-1] + gd["sat_bins"][1:]) / 2
    for side in ("lr", "hr"):
        c = gd[f"sat_{side}_counts"]
        lines.append(f"saturation histogram {side.upper()}: {int(c.sum())} "
                     f"pixels, peak bin at {centers[int(np.argmax(c))]:.2f}")
    noise = np.asarray(gd["noise_means_lr"])
    lines.append(f"LR colour noise over {len(noise)} pairs: mean "
                 f"{noise.mean():.6g}, std {noise.std():.6g}")
    return lines


# -------------------------------------------------------------------- plots
def correlation(rows: list[dict]) -> tuple[list[str], np.ndarray]:
    """(columns, matrix) of pandas' ``df.select_dtypes(include=number)
    .dropna(axis=1, how="all").corr()``: Pearson over the rows where both
    columns are finite, by pandas' ``nancorr`` (Welford's updates in row
    order, the larger column index as x), clipped to [-1, 1], NaN where a
    column is constant over them."""
    cols = [k for k in _numeric_columns(rows)
            if not np.isnan(_column(rows, k)).all()]
    mat = np.stack([_column(rows, k) for k in cols], 1) if cols else \
        np.zeros((len(rows), 0))
    k = mat.shape[1]
    ia, ib = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    xi, yi = np.maximum(ia, ib), np.minimum(ia, ib)
    fin = np.isfinite(mat)
    nobs = np.zeros((k, k))
    mx, my, sx, sy, cxy = (np.zeros((k, k)) for _ in range(5))
    for i in range(mat.shape[0]):
        use = fin[i, xi] & fin[i, yi]
        vx, vy = mat[i, xi], mat[i, yi]
        n = nobs + use
        with np.errstate(invalid="ignore", divide="ignore"):
            dx, dy = vx - mx, vy - my
            nmx = mx + 1.0 / n * dx
            nmy = my + 1.0 / n * dy
            nsx = sx + (vx - nmx) * dx
            nsy = sy + (vy - nmy) * dy
            ncxy = cxy + (vx - nmx) * dy
        mx, my = np.where(use, nmx, mx), np.where(use, nmy, my)
        sx, sy = np.where(use, nsx, sx), np.where(use, nsy, sy)
        cxy, nobs = np.where(use, ncxy, cxy), n
    div = np.sqrt(sx * sy)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.clip(cxy / div, -1.0, 1.0)
    out[(nobs < 1) | (div == 0)] = np.nan
    return cols, out


def _dropna(rows, key) -> np.ndarray:
    x = _column(rows, key)
    return x[~np.isnan(x)]


def _has_values(rows, key) -> bool:
    return key in rows[0] and bool((~np.isnan(_column(rows, key))).any())


def save_visual_example(lr_img, hr_img, output_path, lpips_val):
    """Rescaled LR, HR and their JET difference map (EDA.ipynb cell 8),
    written under ``output_path``'s own name (PNG or JPEG) at the figure's
    100 dpi."""
    from tpusr_torch.viz.colormaps import apply_color_map_jet
    from tpusr_torch.viz.figure import subplots

    lr_resized = (lr_img if lr_img.shape == hr_img.shape else
                  cv.resize_u8(lr_img, hr_img.shape[:2], "bicubic"))
    diff = (lr_resized.to(torch.int16) - hr_img.to(torch.int16)).abs().to(
        torch.uint8)
    # convertScaleAbs(gray) of a uint8 image is the image itself
    diff_color = apply_color_map_jet(cv.bgr2gray(diff))
    fig, axes = subplots(1, 3, figsize=(12, 4))
    axes[0].imshow(lr_resized.flip(-1))
    axes[0].set_title("Rescaled LR")
    axes[1].imshow(hr_img.flip(-1))
    axes[1].set_title("HR")
    lp = f"{lpips_val:.4f}" if lpips_val is not None else "n/a"
    axes[2].imshow(diff_color.flip(-1))
    axes[2].set_title(f"Difference map\nLPIPS: {lp}")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    fig.savefig(output_path)


def create_advanced_visualizations(lr_img, hr_img, output_path):
    """Per-pair 6-panel: LR/HR spectra, HR gradient magnitude, LR GLCM,
    LR noise map, saturation distributions (EDA.ipynb cell 8); the maps on
    the pair's device."""
    from tpusr_torch.viz.figure import subplots

    gray_lr = cv.bgr2gray(lr_img)
    gray_hr = cv.bgr2gray(hr_img)

    def spectrum(g):
        return torch.log1p(torch.fft.fftshift(torch.fft.fft2(g.double())).abs())

    fig, axes = subplots(2, 3, figsize=(20, 10))
    axes[0, 0].imshow(spectrum(gray_lr), cmap="magma")
    axes[0, 0].set_title("LR spectrum (log)")
    axes[0, 1].imshow(spectrum(gray_hr), cmap="magma")
    axes[0, 1].set_title("HR spectrum (log)")
    sx = cv.sobel5(gray_hr, 1, 0)
    sy = cv.sobel5(gray_hr, 0, 1)
    axes[0, 2].imshow(torch.sqrt(sx**2 + sy**2), cmap="viridis")
    axes[0, 2].set_title("HR gradient magnitude")
    axes[1, 0].imshow(torch.log1p(glcm_matrix(gray_lr, 256)), cmap="cividis")
    axes[1, 0].set_title("LR GLCM (log)")
    blur = cv.gaussian_blur_u8(gray_lr, 3)
    axes[1, 1].imshow((gray_lr.float() - blur.float()).abs(), cmap="inferno")
    axes[1, 1].set_title("LR noise map")
    axes[1, 2].hist(cv.bgr2hsv_sv(lr_img)[0].reshape(-1), bins=50, alpha=0.6,
                    label="LR")
    axes[1, 2].hist(cv.bgr2hsv_sv(hr_img)[0].reshape(-1), bins=50, alpha=0.6,
                    label="HR")
    axes[1, 2].set_title("Saturation distribution")
    axes[1, 2].legend()
    for ax in axes.ravel()[:5]:
        ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=120)


def artifact_color_histograms(rows, output_dir):
    """LR-vs-HR histograms for the artifact metrics (EDA cell 10 output)."""
    from tpusr_torch.viz.figure import subplots

    pairs = [("blocking_lr", "blocking_hr"), ("color_noise_lr", "color_noise_hr"),
             ("ringing_lr", "ringing_hr"), ("rms_noise_lr", "rms_noise_hr")]
    fig, axes = subplots(2, 2, figsize=(14, 9))
    for ax, (lo, hi) in zip(axes.ravel(), pairs):
        ax.hist(_dropna(rows, lo), bins=25, alpha=0.6, label="LR")
        ax.hist(_dropna(rows, hi), bins=25, alpha=0.6, label="HR")
        ax.set_title(lo[:-3])
        ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "artifact_color_histograms.png"), dpi=130)


def _mean(rows, key) -> float:
    """pandas' ``Series.mean()``: NaN skipped, NaN when nothing is left."""
    x = _dropna(rows, key)
    return float(np.mean(x)) if len(x) else math.nan


def channel_shape_bars(rows, output_dir):
    """Mean per-channel skew/kurtosis bars, LR vs HR (EDA cell 10 output)."""
    from tpusr_torch.viz.figure import subplots

    fig, axes = subplots(1, 2, figsize=(14, 5))
    xs = np.arange(3)
    for ax, stat in zip(axes, ("skew", "kurt")):
        lr_vals = [_mean(rows, f"ch{c}_{stat}_lr") for c in range(3)]
        hr_vals = [_mean(rows, f"ch{c}_{stat}_hr") for c in range(3)]
        ax.bar(xs - 0.2, lr_vals, 0.4, label="LR")
        ax.bar(xs + 0.2, hr_vals, 0.4, label="HR")
        ax.set_xticks(xs, [f"ch{c}" for c in range(3)])
        ax.set_title(f"Per-channel {stat} (mean)")
        ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "channel_shape_bars.png"), dpi=130)


def create_global_advanced_visualizations(gd, output_path):
    """The dataset's mean spectra, gradient magnitude and GLCM (from the
    accumulators' device copies where ``collect_metrics`` kept them), the
    saturation histograms and the LR colour-noise distribution."""
    from tpusr_torch.viz.figure import subplots

    n = max(1, gd["count"])
    sums = {k: gd.get("on_device", {}).get(k, gd[k]) for k in (
        "lr_fft_sum", "hr_fft_sum", "grad_hr_sum", "glcm_sum")}
    sums = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v)) for k, v in sums.items()}
    fig, axes = subplots(2, 3, figsize=(20, 10))
    axes[0, 0].imshow(torch.log1p(sums["lr_fft_sum"] / n), cmap="magma")
    axes[0, 0].set_title("Mean LR spectrum (log)")
    axes[0, 1].imshow(torch.log1p(sums["hr_fft_sum"] / n), cmap="magma")
    axes[0, 1].set_title("Mean HR spectrum (log)")
    axes[0, 2].imshow(sums["grad_hr_sum"] / n, cmap="viridis")
    axes[0, 2].set_title("Mean HR gradient magnitude")
    axes[1, 0].imshow(torch.log1p(sums["glcm_sum"] / n), cmap="cividis")
    axes[1, 0].set_title("Mean LR GLCM (log)")
    centers = (gd["sat_bins"][:-1] + gd["sat_bins"][1:]) / 2
    axes[1, 1].plot(centers, gd["sat_lr_counts"], label="LR")
    axes[1, 1].plot(centers, gd["sat_hr_counts"], label="HR")
    axes[1, 1].set_title("Saturation histograms")
    axes[1, 1].legend()
    axes[1, 2].hist(gd["noise_means_lr"], bins=30, color="#4c72b0")
    axes[1, 2].set_title("LR color-noise distribution")
    for ax in axes.ravel()[:4]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(output_path, dpi=130)


def basic_distributions(rows, output_dir):
    from tpusr_torch.viz.figure import subplots

    keys = [k for k in ("lpips", "psnr", "ssim", "glcm_contrast",
                        "glcm_homogeneity", "glcm_correlation")
            if _has_values(rows, k)]
    fig, axes = subplots(2, 3, figsize=(16, 8))
    for ax, k in zip(axes.ravel(), keys):
        ax.hist(_dropna(rows, k), bins=30, color="#55a868")
        ax.set_title(k)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "distributions.png"), dpi=130)


def artifact_boxplots(rows, output_dir):
    from tpusr_torch.viz.figure import subplots

    pairs = [("rms_noise_lr", "rms_noise_hr"), ("lap_var_lr", "lap_var_hr"),
             ("blocking_lr", "blocking_hr"), ("color_noise_lr", "color_noise_hr"),
             ("ringing_lr", "ringing_hr"),
             ("saturation_mean_lr", "saturation_mean_hr")]
    fig, axes = subplots(2, 3, figsize=(16, 8))
    for ax, (lo, hi) in zip(axes.ravel(), pairs):
        ax.boxplot([_dropna(rows, lo), _dropna(rows, hi)], tick_labels=["LR", "HR"])
        ax.set_title(lo[:-3])
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "artifact_boxplots.png"), dpi=130)


def correlation_matrix(rows, output_dir):
    from tpusr_torch.viz.figure import subplots

    cols, corr = correlation(rows)
    fig, ax = subplots(figsize=(14, 12))
    im = ax.imshow(corr, cmap="coolwarm", vmin=-1, vmax=1)
    ax.set_xticks(range(len(cols)), cols, rotation=90, fontsize=6)
    ax.set_yticks(range(len(cols)), cols, fontsize=6)
    fig.colorbar(im, shrink=0.8)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "correlation_matrix.png"), dpi=130)


def scatter_relations(rows, output_dir):
    from tpusr_torch.viz.figure import subplots

    rel = [("psnr", "ssim"), ("rms_noise_lr", "psnr"),
           ("blocking_lr", "ssim"), ("color_noise_lr", "psnr")]
    if _has_values(rows, "lpips"):
        rel = [("lpips", "psnr"), ("lpips", "ssim")] + rel[:2]
    fig, axes = subplots(2, 2, figsize=(12, 9))
    for ax, (xk, yk) in zip(axes.ravel(), rel):
        ax.scatter(_column(rows, xk), _column(rows, yk), s=12, alpha=0.6)
        ax.set_xlabel(xk)
        ax.set_ylabel(yk)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "scatter_relations.png"), dpi=130)


def run_eda_pipeline(lr_dir, hr_dir, output_dir="eda_results", top_k_examples=1,
                     glcm_multi_angle=False, glcm_levels=64, interp_map_path="",
                     limit=None, lpips_weights=None, device=None):
    """The EDA (EDA.ipynb cell 10): ``eda_metrics.csv``, ``eda_summary.csv``,
    the JAX pipeline's figures (the global panel, the six figures of the
    metrics table, the best/worst scenarios' dumps by LPIPS, or by PSNR
    without it) and the global panel's numbers printed. ``lpips_weights``
    is an LPIPS-alex ``.npz`` (default
    ``tools.lpips_weights.default_weights_path()``). Returns (rows, gd).
    """
    from tpusr_torch.tools.lpips_weights import default_weights_path

    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    interp_map = None
    if interp_map_path and os.path.exists(interp_map_path):
        with open(interp_map_path, "rb") as f:
            interp_map = pickle.load(f)
    net = None
    path = lpips_weights or default_weights_path()
    if path:
        from tpusr_torch.metrics.lpips import load_lpips_npz

        net = load_lpips_npz(path, device=dev)

    rows, gd = collect_metrics(lr_dir, hr_dir, glcm_multi_angle, glcm_levels,
                               interp_map, limit=limit, lpips_net=net,
                               device=dev)
    write_metrics_csv(rows, os.path.join(output_dir, "eda_metrics.csv"))
    write_summary_csv(summary(rows), os.path.join(output_dir, "eda_summary.csv"))
    for line in global_panel_lines(gd):
        print(f"[eda] {line}")

    create_global_advanced_visualizations(
        gd, os.path.join(output_dir, "advanced_global_panel.png"))
    basic_distributions(rows, output_dir)
    artifact_color_histograms(rows, output_dir)
    artifact_boxplots(rows, output_dir)
    channel_shape_bars(rows, output_dir)
    correlation_matrix(rows, output_dir)
    scatter_relations(rows, output_dir)

    # best/worst scenario dumps (LPIPS if available, else PSNR)
    gd["scenarios"] = pick_scenarios(rows, top_k_examples)
    sc = gd["scenarios"]
    by_name = {r["filename"]: r for r in rows}
    for dname, names in (("best_scenarios", sc["best"]),
                         ("worst_scenarios", sc["worst"])):
        for name in names:
            lr_img, hr_img = load_and_align(os.path.join(lr_dir, name),
                                            os.path.join(hr_dir, name),
                                            interp_map, device=dev)
            base = os.path.basename(name)
            save_visual_example(
                lr_img, hr_img,
                os.path.join(output_dir, "LPIPS_Scenarios", dname, base),
                by_name[name]["lpips"] if sc["key"] == "lpips" else None)
            create_advanced_visualizations(
                lr_img, hr_img,
                os.path.join(output_dir, "LPIPS_Scenarios", dname,
                             "advanced_" + base))
    print(f"[eda] {len(rows)} pairs; best by {sc['key']}: {sc['best']}, "
          f"worst: {sc['worst']}; figures written to {output_dir}")
    return rows, gd
