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


@pytest.mark.parametrize("shape", [(40, 48), (17, 23)])
def test_twin_with_tensor_params_matches_scan_and_pallas(shape):
    """sigma and h as 0-d float32 tensors, as the classic path passes them
    (K4 reads them on the device)."""
    img = _noisy(shape, sum(shape) + 1)
    sigma = torch.tensor(0.08)
    h = 1.15 * sigma
    got = nlm.nlm_denoise(torch.from_numpy(img), sigma, h).numpy()
    scan = np.asarray(jax_nl_means(jnp.asarray(img), float(sigma), float(h)))
    pallas = np.asarray(nlm_denoise_pallas(
        jnp.asarray(img), jnp.asarray(sigma.numpy()), jnp.asarray(h.numpy()),
        interpret=True))
    np.testing.assert_allclose(got, scan, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


def test_twin_takes_sigma_and_h_as_tensors():
    img = torch.from_numpy(_noisy((20, 24), 3))
    sigma = estimate_sigma(img)
    a = nlm.nlm_denoise(img, sigma, 1.15 * sigma)
    b = nlm.nl_means_denoise(img, float(sigma), float(1.15 * sigma))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)
    assert sigma.dim() == 0 and sigma.dtype == torch.float32


@pytest.mark.parametrize("hw,n_sms", [((128, 128), 132), ((2048, 2048), 132),
                                      ((512, 512), 132), ((29, 61), 132),
                                      ((128, 128), 114), ((1024, 1024), 132),
                                      ((1, 2048), 132)])
def test_launch_config_fills_the_card(hw, n_sms):
    """The kernel's launch (csrc/nlm.cu, 8-warp blocks): one warp per pixel
    run unless that grid leaves an SM without a block, then the split; at
    128^2, the classic comparison's size, at least one block per SM; the
    grid covers the image."""
    rows, split = nlm.launch_config(*hw, n_sms)
    assert (rows, split) in nlm.CONFIGS
    gx, gy = nlm.grid(*hw, rows, split)
    assert gx * nlm.COLS >= hw[1] and gy * nlm.WARPS // split * rows >= hw[0]
    assert (gx - 1) * nlm.COLS < hw[1]
    nx, ny = nlm.grid(*hw, *nlm.NO_SPLIT)
    assert (split == 1) == (nx * ny >= n_sms)
    if hw == (128, 128):
        assert gx * gy >= n_sms
    if hw == (2048, 2048):
        assert split == 1
    assert all(168 % s == 0 and nlm.WARPS % s == 0 for _, s in nlm.CONFIGS)


def _box_d2(xp, H, W, dy, dx):
    """d2 of offset (dy, dx) at every pixel of the (H, W) image, from the
    8-padded float32 ``xp`` in K4's (and the Pallas kernel's) order: the
    squared differences, the column sums top to bottom, the row sums left to
    right, then 1/25."""
    a0 = 6
    d = (xp[a0:a0 + H + 4, a0:a0 + W + 4]
         - xp[a0 + dy:a0 + dy + H + 4, a0 + dx:a0 + dx + W + 4])
    sd = d * d
    c = sd[0:H]
    for u in range(1, 5):
        c = c + sd[u:u + H]
    b = c[:, 0:W]
    for u in range(1, 5):
        b = b + c[:, u:u + W]
    return b * np.float32(1 / 25)


@pytest.mark.parametrize("shape", [(23, 31), (9, 9)])
def test_weight_of_q_at_p_is_that_of_minus_q_at_p_plus_q(shape):
    """The premise of nlm_work's count: in float32, d2 (and so the weight,
    a function of d2 alone) of offset q at pixel p equals, bit for bit, d2
    of -q at p + q, for every p with p + q in the image."""
    H, W = shape
    xp = np.pad(_noisy(shape, 5), 8, mode="reflect")
    assert xp.dtype == np.float32
    for k in range(84):
        dy, dx = k // 13 - 6, k % 13 - 6
        a, b = _box_d2(xp, H, W, dy, dx), _box_d2(xp, H, W, -dy, -dx)
        i0, i1 = max(0, -dy), H - max(0, dy)
        j0, j1 = max(0, -dx), W - max(0, dx)
        if i0 >= i1 or j0 >= j1:
            continue
        np.testing.assert_array_equal(
            a[i0:i1, j0:j1].view(np.uint32),
            b[i0 + dy:i1 + dy, j0 + dx:j1 + dx].view(np.uint32))


@pytest.mark.parametrize("h,w", [(128, 128), (37, 300), (5, 3), (1, 64)])
def test_nlm_work_counts_the_least_work(h, w):
    """chip_smoke.nlm_work, which sets K4's bound, against a count of the
    positions themselves: each of the 84 offsets q before the centre needs
    its weights on the image and on the image moved by -q (the premise
    above); over them the squared differences on the box-extended positions
    (2 ops), the column sums on the weight rows (4 adds), the row sums (4),
    4 ops and one expf per weight; 3 ops per pixel and offset for the 168
    accumulations, one division per pixel; the image read and written once
    and the two scalars."""
    from chip_smoke import nlm_work

    def widen(mask, rows, cols):             # every position within the box
        out = np.zeros_like(mask)
        for u in range(-rows, rows + 1):
            for v in range(-cols, cols + 1):
                out |= np.roll(mask, (u, v), axis=(0, 1))
        return out

    want_ops, want_exps = 168 * 3 * h * w + h * w, 0
    for k in range(84):
        dy, dx = k // 13 - 6, k % 13 - 6
        m = np.zeros((h + 20, w + 20), bool)        # margins of 10
        m[10:10 + h, 10:10 + w] = True
        m[10 - dy:10 - dy + h, 10 - dx:10 - dx + w] = True
        n_w = int(m.sum())
        want_ops += (2 * int(widen(m, 2, 2).sum()) + 4 * int(widen(m, 0, 2).sum())
                     + 8 * n_w)
        want_exps += n_w
    ops, exps, nbytes = nlm_work(h, w)
    assert (ops, exps) == (want_ops, want_exps)
    assert exps < 168 * h * w
    assert nbytes == 4 * h * w + 4 * h * w + 8


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
