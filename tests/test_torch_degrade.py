"""The port's degradation model (``tpusr_torch/data/degrade.py``) against
JAX's ``tpusr.data.degrade.degrade_image_core``.

The port's core takes its draws as arguments, and the port's
``sample_draws`` makes JAX's draws from a key (``tpusr_torch.core.prng``).
``jax_draws`` below computes them with ``jax.random`` (the eight key splits
of ``degrade_image_core`` and ``fold_in(key, 99)`` for the noise, taken
as the ``erf_inv(u)`` that ``jax.random.normal`` scales by sqrt(2)): it is
the oracle that ``sample_draws`` is held to, and the draws handed to the
port's core, whose LR images are compared at atol 1e-5 on [0, 1] (blur
sums and the resize matrix products in float32, in another order). The keys are chosen to cover every branch: each
Gaussian size, each motion size, each interpolation, noise on and off.

The JPEG stage takes JAX's ``split(fold_in(key, 7))`` draws too, so
``degrade_image(apply_jpeg=True)`` runs on JAX's own choices; the port's
encoder and decoder are held to cv2's bytes and pixels, so the round trip is
equal wherever the uint8 image fed to the encoder is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.data import degrade as jd
from tpusr_torch.core import prng
from tpusr_torch.data import degrade as td

ATOL = 1e-5
HR_SHAPE = (32, 40, 3)


def jax_draws(key, hr_shape, cfg=td.DegradeConfig()) -> td.DegradeDraws:
    """The draws ``tpusr.data.degrade.degrade_image_core`` makes from
    ``key``, as the port's ``DegradeDraws``."""
    keys = jax.random.split(key, 8)
    k_idx = int(jax.random.randint(keys[1], (), 0, len(cfg.gauss_ksizes)))
    m_idx = int(jax.random.randint(keys[4], (), 0, len(cfg.motion_ksizes)))
    # jax.random.normal is sqrt(2) erf_inv(u), u uniform on
    # (nextafter(-1, 0), 1): the core takes erf_inv(u)
    u = jax.random.uniform(jax.random.fold_in(key, 99),
                           td.lr_shape(hr_shape, cfg),
                           minval=np.nextafter(np.float32(-1), np.float32(0)),
                           maxval=1.0)
    j1, j2 = jax.random.split(jax.random.fold_in(key, 7))
    return td.DegradeDraws(
        blur=bool(jax.random.uniform(keys[0]) < cfg.p_gauss_blur),
        ksize=cfg.gauss_ksizes[k_idx],
        sigma=float(jax.random.uniform(keys[2], minval=cfg.sigma_range[0],
                                       maxval=cfg.sigma_range[1])),
        motion=bool(jax.random.uniform(keys[3]) < cfg.p_motion_blur),
        motion_size=cfg.motion_ksizes[m_idx],
        interp=int(jax.random.randint(keys[5], (), 0, 4)),
        noise=bool(jax.random.uniform(keys[6]) < cfg.p_noise),
        noise_std=float(jax.random.uniform(keys[7], minval=cfg.noise_range[0],
                                           maxval=cfg.noise_range[1])),
        noise_erf=torch.from_numpy(np.array(jax.lax.erf_inv(u))),
        jpeg=bool(float(jax.random.uniform(j1)) < cfg.p_jpeg),
        jpeg_quality=int(jax.random.randint(j2, (), cfg.jpeg_q_range[0],
                                            cfg.jpeg_q_range[1])))


def _covering_seeds(n_max=200):
    """The first seeds whose draws, together, take every branch."""
    want = ({("blur", k) for k in (3, 5, 7)} | {("motion", k) for k in (5, 7, 9)}
            | {("interp", i) for i in range(4)} | {("noise", b) for b in (0, 1)}
            | {("blur", 0), ("motion", 0)})
    seeds = []
    for s in range(n_max):
        d = jax_draws(jax.random.PRNGKey(s), HR_SHAPE)
        got = {("blur", d.ksize if d.blur else 0),
               ("motion", d.motion_size if d.motion else 0),
               ("interp", d.interp), ("noise", int(d.noise))}
        if got & want:
            seeds.append(s)
            want -= got
        if not want:
            return seeds
    raise AssertionError(f"branches not covered: {want}")


SEEDS = _covering_seeds()


@pytest.mark.parametrize("seed", SEEDS)
def test_core_on_jax_draws_equals_jax(seed):
    hr = np.random.default_rng(seed).random(HR_SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want, w_idx = jd.degrade_image_core(jnp.asarray(hr), key)
    got, g_idx = td.degrade_image_core(torch.from_numpy(hr),
                                       jax_draws(key, HR_SHAPE))
    assert g_idx == int(w_idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 20, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_the_seeds_cover_every_branch():
    seen = set()
    for s in SEEDS:
        d = jax_draws(jax.random.PRNGKey(s), HR_SHAPE)
        seen |= {("blur", d.ksize if d.blur else 0),
                 ("motion", d.motion_size if d.motion else 0),
                 ("interp", d.interp), ("noise", int(d.noise))}
    assert {("blur", k) for k in (0, 3, 5, 7)} <= seen
    assert {("motion", k) for k in (0, 5, 7, 9)} <= seen
    assert {("interp", i) for i in range(4)} <= seen
    assert {("noise", 0), ("noise", 1)} <= seen


def test_quarter_scale_on_jax_draws_equals_jax():
    """The x0.25 degradation of a 64^2 image (the commands' HR/LR layout)."""
    cfg_j, cfg_t = jd.DegradeConfig(scale_factor=0.25), td.DegradeConfig(
        scale_factor=0.25)
    hr = np.random.default_rng(9).random((64, 64, 3)).astype(np.float32)
    for s in SEEDS[:4]:
        key = jax.random.PRNGKey(s)
        want, _ = jd.degrade_image_core(jnp.asarray(hr), key, cfg_j)
        got, _ = td.degrade_image_core(torch.from_numpy(hr),
                                       jax_draws(key, hr.shape, cfg_t), cfg_t)
        assert tuple(got.shape) == (16, 16, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_blur_kernels_and_reflect_padding_equal_jax():
    img = np.random.default_rng(2).random((9, 11, 3)).astype(np.float32) * 255
    for k, sigma in ((3, 0.9), (5, 1.5), (7, 2.0)):
        kj = jd._gauss_kernel1d(k, jnp.float32(sigma))
        kt = td._gauss_kernel1d(k, float(np.float32(sigma)), "cpu")
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=1e-7)
        want = jd._sep_blur(jnp.asarray(img), kj, kj)
        got = td._sep_blur(torch.from_numpy(img), kt, kt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL * 255)


def test_sample_draws_is_seeded_and_in_range():
    cfg = td.DegradeConfig()
    a = td.sample_draws(prng.PRNGKey(3), HR_SHAPE, cfg)
    b = td.sample_draws(prng.PRNGKey(3), HR_SHAPE, cfg)
    assert a.ksize == b.ksize and a.sigma == b.sigma and a.interp == b.interp
    assert torch.equal(a.noise_erf, b.noise_erf)
    draws = [td.sample_draws(prng.PRNGKey(s), HR_SHAPE, cfg)
             for s in range(64)]
    for d in draws:
        assert d.ksize in cfg.gauss_ksizes and d.motion_size in cfg.motion_ksizes
        assert 0.8 <= d.sigma <= 2.0 and 2.0 <= d.noise_std <= 10.0
        assert tuple(d.noise_erf.shape) == (16, 20, 3)
    assert {d.interp for d in draws} == {0, 1, 2, 3}
    assert {d.blur for d in draws} == {d.noise for d in draws} == {False, True}


def test_degrade_image_wraps_the_draws_and_the_core():
    hr = np.random.default_rng(4).random(HR_SHAPE).astype(np.float32)
    lr, name = td.degrade_image(hr, apply_jpeg=False, seed=5)
    d = td.sample_draws(prng.PRNGKey(5), HR_SHAPE)
    want, idx = td.degrade_image_core(torch.from_numpy(hr), d)
    assert isinstance(lr, np.ndarray) and name == td._INTERP_NAMES[idx]
    np.testing.assert_array_equal(lr, want.numpy())
    lr_t, name_t = td.degrade_image(torch.from_numpy(hr), prng.PRNGKey(5),
                                    apply_jpeg=False)
    assert isinstance(lr_t, torch.Tensor) and name_t == name
    np.testing.assert_array_equal(lr_t.numpy(), lr)
    assert lr.min() >= 0.0 and lr.max() <= 1.0


def _jpeg_seeds():
    """The first seeds whose JPEG draws take the stage off once and on at
    four qualities."""
    off, on = [], {}
    for s in range(100):
        d = jax_draws(jax.random.PRNGKey(s), HR_SHAPE)
        if d.jpeg and d.jpeg_quality not in on and len(on) < 4:
            on[d.jpeg_quality] = s
        elif not d.jpeg and not off:
            off.append(s)
        if off and len(on) == 4:
            return off + sorted(on.values())
    raise AssertionError("no JPEG seeds")


JPEG_SEEDS = _jpeg_seeds()


def _u8(lr01):
    return np.clip(np.asarray(lr01) * 255.0, 0, 255).round().astype(np.uint8)


@pytest.mark.parametrize("seed", JPEG_SEEDS)
def test_degrade_image_with_jpeg_on_jax_draws_equals_jax(seed):
    """``degrade_image(apply_jpeg=True)`` against JAX's on JAX's draws: first
    the uint8 image the encoder is fed (the cores agree within 1e-5, which
    can still round apart at a half level), then the round trip."""
    hr = np.random.default_rng(seed).random(HR_SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(key, HR_SHAPE)
    core_j, _ = jd.degrade_image_core(jnp.asarray(hr), key)
    core_t, _ = td.degrade_image_core(torch.from_numpy(hr), draws)
    n_apart = int((_u8(core_j) != _u8(core_t.numpy())).sum())
    assert n_apart == 0, f"{n_apart} uint8 encoder inputs round apart"
    want, w_name = jd.degrade_image(hr, key=key, apply_jpeg=True)
    got, g_name = td.degrade_with_draws(torch.from_numpy(hr), draws,
                                        apply_jpeg=True, to_numpy=True)
    assert g_name == w_name and got.dtype == np.float32
    if draws.jpeg:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_jpeg_seeds_take_the_stage_off_and_on_at_several_qualities():
    draws = [jax_draws(jax.random.PRNGKey(s), HR_SHAPE) for s in JPEG_SEEDS]
    assert [d.jpeg for d in draws].count(False) == 1
    assert len({d.jpeg_quality for d in draws if d.jpeg}) == 4
    assert all(20 <= d.jpeg_quality < 60 for d in draws)


@pytest.mark.parametrize("quality", [20, 41, 59])
def test_jpeg_roundtrip_equals_jax(quality):
    lr = np.random.default_rng(quality).random((17, 23, 3)).astype(np.float32)
    want = jd.jpeg_roundtrip(lr, quality)
    got = td.jpeg_roundtrip(lr, quality)
    np.testing.assert_array_equal(got, want)
    got_t = td.jpeg_roundtrip(torch.from_numpy(lr), quality)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_sample_draws_takes_the_jpeg_draws_last():
    """The JPEG stage's draws come from ``split(fold_in(key, 7))``, apart
    from the core's eight keys, as in JAX's ``degrade_image``."""
    cfg = td.DegradeConfig()
    draws = [td.sample_draws(prng.PRNGKey(s), HR_SHAPE, cfg)
             for s in range(64)]
    assert {d.jpeg for d in draws} == {False, True}
    assert all(20 <= d.jpeg_quality < 60 for d in draws)
    key = prng.PRNGKey(7)
    d = td.sample_draws(key, HR_SHAPE, cfg)
    k1, k2 = prng.split(prng.fold_in(key, 7))
    assert d.jpeg == (float(prng.uniform(k1)) < np.float32(cfg.p_jpeg))
    assert d.jpeg_quality == int(prng.randint(k2, (), 20, 60))


@pytest.mark.parametrize("seed", range(0, 40, 3))
def test_sample_draws_equal_jax_draws(seed):
    """Every choice and the noise tensor of the port's ``sample_draws``
    equal JAX's from the same key, bit for bit."""
    want = jax_draws(jax.random.PRNGKey(seed), HR_SHAPE)
    got = td.sample_draws(prng.PRNGKey(seed), HR_SHAPE)
    for f in ("blur", "ksize", "sigma", "motion", "motion_size", "interp",
              "noise", "noise_std", "jpeg", "jpeg_quality"):
        assert getattr(got, f) == getattr(want, f), f
    assert torch.equal(got.noise_erf, want.noise_erf)


@pytest.mark.parametrize("seed", [0, 2, 3, 4])
def test_degrade_image_from_a_bare_seed_equals_jax(seed):
    """``degrade_image`` from a bare seed against JAX's: the same draws, so
    the same interpolation, and LR images within ATOL (equal where only
    the noise and the resize apply; XLA's blur sums differ from torch's
    in the last bit)."""
    hr = np.random.default_rng(seed).random(HR_SHAPE).astype(np.float32)
    want, w_name = jd.degrade_image(hr, seed=seed, apply_jpeg=False)
    got, g_name = td.degrade_image(hr, seed=seed, apply_jpeg=False)
    assert g_name == w_name
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
