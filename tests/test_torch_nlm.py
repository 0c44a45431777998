"""K4 of the port (tpusr_torch/core/nlm.py) and what surrounds it, against the
JAX package on the CPU: the plain twin against the scan formulation
(``tpusr.classic.algorithms.nl_means_denoise``) and the Pallas kernel in
interpret mode (``nlm_denoise_pallas``); the wavelet sigma estimator; the
two-sided pad indices against ``np.pad``. The CUDA kernel itself is held
against the twin on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusr.classic.algorithms import estimate_sigma as jax_estimate_sigma
from tpusr.classic.algorithms import nl_means_denoise as jax_nl_means
from tpusr.classic.algorithms import non_local_means as jax_non_local_means
from tpusr.core.pallas_nlm import nlm_denoise_pallas
from tpusr_torch.classic.algorithms import estimate_sigma, non_local_means
from tpusr_torch.core import nlm
from tpusr_torch.core.pad import pad_2d, pad_index


def _noisy(shape, seed, sigma=0.08):
    rng = np.random.default_rng(seed)
    img = 0.5 + rng.normal(0, sigma, shape)
    img[: shape[0] // 2, : shape[1] // 3] += 0.3          # an edge
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.mark.parametrize("shape", [(40, 48), (17, 23)])
def test_twin_matches_scan_and_pallas(shape):
    img = _noisy(shape, sum(shape))
    sigma, h = 0.08, 1.15 * 0.08
    nlm.reset_launch_counts()
    got = nlm.nlm_denoise(torch.from_numpy(img), sigma, h).numpy()
    assert got.shape == shape and got.dtype == np.float32
    scan = np.asarray(jax_nl_means(jnp.asarray(img), sigma, h))
    pallas = np.asarray(nlm_denoise_pallas(jnp.asarray(img), sigma, h,
                                           interpret=True))
    np.testing.assert_allclose(got, scan, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    assert np.abs(got - img).max() > 1e-2           # it does denoise
    # a CPU tensor takes the twin and never reaches the kernel
    assert nlm.LAUNCHES["nlm_denoise"] == 0


def test_twin_takes_sigma_and_h_as_tensors():
    img = torch.from_numpy(_noisy((20, 24), 3))
    sigma = estimate_sigma(img)
    a = nlm.nlm_denoise(img, sigma, 1.15 * sigma)
    b = nlm.nl_means_denoise(img, float(sigma), float(1.15 * sigma))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)
    p = nlm.nlm_params(sigma, 1.15 * sigma, "cpu")
    assert p.dtype == torch.float32 and tuple(p.shape) == (2,)
    np.testing.assert_allclose(p.numpy(), [float(sigma) ** 2,
                                           1.0 / (1.15 * float(sigma)) ** 2],
                               rtol=1e-5)


def _sigma_images():
    rng = np.random.default_rng(11)
    noise = np.clip(0.5 + rng.normal(0, 0.05, (48, 40)), 0, 1)
    # a black band: its HH coefficients are exactly 0 and leave the median
    banded = noise.copy()
    banded[:, :16] = 0.0
    odd = np.clip(0.3 + rng.normal(0, 0.1, (17, 23)), 0, 1)
    return {"noise": noise, "zero band": banded, "odd": odd,
            "all zero": np.zeros((12, 12))}


@pytest.mark.parametrize("name", sorted(_sigma_images()))
def test_estimate_sigma_matches_jax(name):
    img = _sigma_images()[name].astype(np.float32)
    got = estimate_sigma(torch.from_numpy(img))
    want = float(jax_estimate_sigma(jnp.asarray(img)))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=0)
    if name == "zero band":   # the zeros are excluded, not counted
        assert want > 0.5 * float(jax_estimate_sigma(jnp.asarray(
            _sigma_images()["noise"].astype(np.float32))))


def test_non_local_means_matches_jax():
    lr01 = _noisy((24, 20), 5)
    hr = np.zeros((96, 80), np.float32)
    got = non_local_means(torch.from_numpy(hr), torch.from_numpy(lr01)).numpy()
    want = np.asarray(jax_non_local_means(jnp.asarray(hr), jnp.asarray(lr01),
                                          use_pallas=False))
    assert got.shape == (96, 80)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


PAD_CASES = [(1, 3, 2), (2, 5, 4), (3, 1, 2), (5, 4, 4), (5, 9, 13),
             (9, 8, 8), (4, 0, 7)]


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("n,before,after", PAD_CASES)
def test_pad_index_matches_np_pad(n, before, after, mode):
    got = pad_index(n, before, after, mode).numpy()
    np.testing.assert_array_equal(got, np.pad(np.arange(n), (before, after),
                                              mode=mode))


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
def test_pad_2d_matches_np_pad(mode):
    x = np.random.default_rng(2).random((3, 5)).astype(np.float32)
    got = pad_2d(torch.from_numpy(x), 8, mode).numpy()     # pad >= both dims
    np.testing.assert_array_equal(got, np.pad(x, 8, mode=mode))
    with pytest.raises(ValueError):
        pad_index(4, 1, 1, "edge")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        nlm.nlm_denoise(torch.zeros((2, 4, 4)), 0.1, 0.1)
    with pytest.raises(TypeError):
        nlm.nlm_denoise(torch.zeros((4, 4), dtype=torch.float64), 0.1, 0.1)
    with pytest.raises(ValueError):      # no device other than cpu/cuda
        nlm.nlm_denoise(torch.zeros((4, 4), device="meta"), 0.1, 0.1)
