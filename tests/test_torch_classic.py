"""The classic-SR comparison in the port (tpusr_torch/classic/) against the JAX
package (tpusr/classic/) on the CPU: each of the eight algorithms, the
harness's quality metrics, and the ranking given the same summary.

Where the reference stores an SR image as uint8 (a round or a floor of a
float image), sums taken in another order can put a value on the other
side of an integer: those pixels are counted, printed and bounded at 0.1%
of the image, never more than one grey level apart. Time and memory are the
device's own and enter no comparison."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusr.classic import algorithms as JA
from tpusr.classic import harness as JH
from tpusr.classic.harness import run_classic_comparison as jax_run
from tpusr.metrics.stats import build_metrics_summary as jax_build_summary
from tpusr.metrics.stats import rank_algorithms as jax_rank
from tpusr_torch.classic import algorithms as TA
from tpusr_torch.classic.harness import (CLASSIC_ALGORITHMS, METRICS,
                                         RANKING_WEIGHTS,
                                         run_classic_comparison, sr_images)
from tpusr_torch.core.resize import resize
from tpusr_torch.metrics.image import rgb_to_gray
from tpusr_torch.metrics.stats import build_metrics_summary, rank_algorithms

HR, LR = 48, 12
RANK_ARGS = dict(maximize=["psnr_mean", "ssim_mean"],
                 minimize=["time_mean", "memory_mean", "mae_mean", "rmse_mean",
                           "grad_mse_mean", "kl_luma_mean", "kl_color_mean"],
                 weights=RANKING_WEIGHTS)


def synthetic_pair(seed, hr=HR, lr=LR):
    """A uint8 RGB HR image (smooth noise plus two sharp-edged rectangles)
    and its area-downscaled uint8 LR image."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((hr // 8, hr // 8, 3)).astype(np.float32))
    img = resize(coarse, (hr, hr), "bicubic").numpy() * 200.0 + 20.0
    img[hr // 4: hr // 2, hr // 5: hr // 2] += 60.0
    img[hr // 2: 3 * hr // 4, hr // 2: 7 * hr // 8] -= 50.0
    img += rng.normal(0, 3.0, img.shape)
    hr_u8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
    lr_f = resize(torch.from_numpy(hr_u8.astype(np.float32)), (lr, lr), "area")
    return hr_u8, np.clip(np.round(lr_f.numpy()), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    hr, lr = synthetic_pair(3)
    hr_f, lr_f = hr.astype(np.float32), lr.astype(np.float32)
    hr_g = torch.round(rgb_to_gray(torch.from_numpy(hr_f)))
    lr_g = torch.round(rgb_to_gray(torch.from_numpy(lr_f)))
    return hr_f, lr_f, hr_g, lr_g


def _count_level_flips(name, got, want, quantize):
    """Pixels whose stored uint8 value differs; at most 0.1%, by one level."""
    d = np.abs(quantize(got) - quantize(want))
    n = int((d > 0).sum())
    print(f"{name}: {n} of {d.size} stored values differ by one grey level")
    assert d.max() <= 1.0
    assert n <= 0.001 * d.size, (name, n)


def _round_u8(x):
    return np.clip(np.round(x), 0, 255)


def _floor_max_norm(x):
    return np.floor(x / x.max() * 255.0)


def _port_and_jax(name, hr_f, lr_f, hr_g, lr_g):
    out = (HR, HR)
    hg, lg = jnp.asarray(hr_g.numpy()), jnp.asarray(lr_g.numpy())
    calls = {
        "bilinear": (lambda: TA.interpolate_bilinear(torch.from_numpy(lr_f), out),
                     lambda: JA.interpolate_bilinear(jnp.asarray(lr_f), out)),
        "bicubic": (lambda: TA.interpolate_bicubic(torch.from_numpy(lr_f), out),
                    lambda: JA.interpolate_bicubic(jnp.asarray(lr_f), out)),
        "area": (lambda: TA.interpolate_area(torch.from_numpy(lr_f), out),
                 lambda: JA.interpolate_area(jnp.asarray(lr_f), out)),
        "lanczos": (lambda: TA.interpolate_lanczos(torch.from_numpy(lr_f), out),
                    lambda: JA.interpolate_lanczos(jnp.asarray(lr_f), out)),
        "ibp": (lambda: TA.back_projection(hr_g, lr_g, 10),
                lambda: JA.back_projection(hg, lg, 10)),
        "nlm": (lambda: TA.non_local_means(hr_g, lr_g / 255.0),
                lambda: JA.non_local_means(hg, lg / 255.0, use_pallas=False)),
        "egi": (lambda: TA.edge_guided_interpolation(hr_g, lr_g),
                lambda: JA.edge_guided_interpolation(hg, lg)),
        "freq": (lambda: TA.frequency_extrapolation(hr_g, lr_g),
                 lambda: JA.frequency_extrapolation(hg, lg)),
    }
    port, jax_fn = calls[name]
    got = port()
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(jax_fn())


@pytest.mark.parametrize("name", CLASSIC_ALGORITHMS)
def test_algorithm_matches_jax(pair, name):
    got, want = _port_and_jax(name, *pair)
    assert got.shape == want.shape
    assert got.shape[:2] == (HR, HR)
    if name == "egi":
        # the bilinear upscale is rounded inside the algorithm: a value on
        # the other side of .5 is one level apart, every other within 1e-3
        off = int((np.abs(got - want) > 1e-3).sum())
        print(f"egi (inner round): {off} of {got.size} values differ by one "
              f"grey level")
        assert off <= 0.001 * got.size
        assert np.abs(got - want).max() <= 1.0 + 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    if name in ("bilinear", "bicubic", "area", "lanczos"):
        _count_level_flips(name, got, want, _round_u8)
    elif name in ("ibp", "egi"):
        _count_level_flips(name, got, want, np.floor)
    elif name == "freq":
        _count_level_flips(name, got, want, _floor_max_norm)


def _jax_sr_images(hr, lr):
    """The SR images the JAX harness scores (tpusr/classic/harness.py:93-116)."""
    hr_f, lr_f = jnp.asarray(hr.astype(np.float32)), jnp.asarray(lr.astype(np.float32))
    out = hr.shape[:2]
    imgs = {name: jnp.clip(jnp.round(fn(lr_f, out)), 0, 255)
            for name, fn in (("bilinear", JA.interpolate_bilinear),
                             ("bicubic", JA.interpolate_bicubic),
                             ("area", JA.interpolate_area),
                             ("lanczos", JA.interpolate_lanczos))}
    hr_g, lr_g = JH._gray_cv2_u8(hr_f), JH._gray_cv2_u8(lr_f)
    imgs["ibp"] = jnp.floor(JA.back_projection(hr_g, lr_g, iterations=10))
    imgs["nlm"] = JA.non_local_means(hr_g, lr_g / 255.0, use_pallas=False)
    imgs["egi"] = jnp.floor(JA.edge_guided_interpolation(hr_g, lr_g))
    freq = JA.frequency_extrapolation(hr_g, lr_g)
    mx = freq.max()
    imgs["freq"] = jnp.where(mx > 0, jnp.floor(freq / mx * 255.0), jnp.floor(freq))
    return {k: np.asarray(v) for k, v in imgs.items()}


def _jax_metric_block(alg, hr, sr):
    """The JAX harness's metric block of one stored SR image."""
    hr_f = jnp.asarray(hr.astype(np.float32))
    if alg in ("bilinear", "bicubic", "area", "lanczos"):
        block = JH._color_metrics(hr_f, jnp.asarray(sr))
    else:
        hr_g = JH._gray_cv2_u8(hr_f)
        span = hr_g.max() - hr_g.min()
        dr = jnp.where(span != 0, span, 255.0) if alg == "nlm" else 255.0
        block = JH._gray_metrics(hr_g, jnp.asarray(sr), dr)
    return {m: float(v) for m, v in block.items()}


@pytest.fixture(scope="module")
def comparisons():
    pairs = [synthetic_pair(s) for s in (5, 6)]
    hr, lr = [p[0] for p in pairs], [p[1] for p in pairs]
    port = run_classic_comparison(hr, lr, device="cpu")
    images = [(sr_images(torch.from_numpy(h.astype(np.float32)),
                         torch.from_numpy(l.astype(np.float32))),
               _jax_sr_images(h, l)) for h, l in pairs]
    return port, jax_run(hr, lr), pairs, images


@pytest.mark.parametrize("metric", METRICS)
def test_harness_metrics_match_jax(comparisons, metric):
    """Every metric of every algorithm to rtol 1e-4: against the JAX
    harness where both packages stored the same SR image, and against the
    JAX metric block on the port's SR image where a floor or a round put a
    few pixels one grey level apart (counted, at most 0.1%)."""
    (_, _, _, stats), (_, _, _, jstats), pairs, images = comparisons
    assert set(stats[metric]) == set(CLASSIC_ALGORITHMS)
    for alg in CLASSIC_ALGORITHMS:
        assert len(stats[metric][alg]) == len(jstats[metric][alg]) == 2
        for i, ((hr, _), (port_imgs, jax_imgs)) in enumerate(zip(pairs, images)):
            got = stats[metric][alg][i]
            sr = port_imgs[alg].numpy()
            if alg == "nlm":       # stored as a float image: no flips
                np.testing.assert_allclose(sr, jax_imgs[alg], atol=1e-5)
                same = True
            else:
                same = np.array_equal(sr, jax_imgs[alg])
            if not same:
                _count_level_flips(f"pair {i} {alg}", sr, jax_imgs[alg],
                                   lambda x: x)
            want = (jstats[metric][alg][i] if same
                    else _jax_metric_block(alg, hr, sr)[metric])
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0,
                                       err_msg=f"pair {i} {alg} {metric}")


def test_harness_summary_time_memory_and_quirks(comparisons):
    (summary, ranked, scores, stats), *_ = comparisons
    assert set(summary) == set(CLASSIC_ALGORITHMS) and len(ranked) == 8
    for alg in CLASSIC_ALGORITHMS:
        assert np.isfinite(summary[alg]["psnr_mean"]), alg
        assert all(t > 0 for t in stats["time"][alg])
        assert all(m >= 0 for m in stats["memory"][alg])   # 0.0 on the CPU
    # the reference's quirk: NLM's [0,1]-vs-[0,255] scoring buries it
    assert summary["nlm"]["psnr_mean"] < 10.0
    assert summary["bicubic"]["psnr_mean"] > 20.0
    assert sorted(scores, key=scores.get, reverse=True) == [a for a, _ in ranked]


def test_ranking_matches_jax_given_the_same_summary(comparisons):
    (_, _, _, stats), (jsummary, jranked, jscores, jstats), *_ = comparisons
    # the same summary through both packages' ranking
    ranked, scores, _ = rank_algorithms(jsummary, **RANK_ARGS)
    assert ranked == jranked
    assert scores == jscores
    # the port's quality metrics with the JAX run's time and memory
    args = [jstats["time"], jstats["memory"]] + [
        stats[m] for m in ("psnr", "ssim", "mae", "rmse", "grad", "epi", "hf",
                           "kl_luma", "kl_color")]
    summary = build_metrics_summary(*args)
    jsummary2 = jax_build_summary(*args)
    assert [a for a, _ in rank_algorithms(summary, **RANK_ARGS)[0]] == \
        [a for a, _ in jranked]
    assert rank_algorithms(summary, **RANK_ARGS)[0] == \
        jax_rank(jsummary2, **RANK_ARGS)[0]
