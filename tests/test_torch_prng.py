"""The port's counterpart of ``jax.random`` and of flax's key paths
(``tpusr_torch/core/prng.py``, ``tpusr_torch/models/init.py``) against JAX
0.9's partitionable threefry2x32 and flax's ``init`` on the CPU, with no
JAX draws or weights carried into the port.

- Keys, ``split``, ``fold_in``, ``bits``, ``uniform``, ``randint``,
  ``bernoulli`` and ``permutation`` equal ``jax.random``'s bit for bit, at
  the keys, shapes and ranges the JAX package uses.
- ``normal`` and ``truncated_normal`` are held to 0 ulp with 0 values
  apart: XLA's float32 ``erf_inv`` and ``log1p`` are rewritten op for op,
  with its fused multiply-adds computed exactly; both the computed path
  (small draws) and the table path (large draws) are checked.
- The fresh parameters of every model equal flax's ``init`` from the same
  key, bit for bit (spectral ``u`` included).
- The seeded paths built on them: the gate's surfaces, labels and crop
  pools, the degradation draws (``tests/test_torch_degrade.py``), and a few
  trainer steps from a bare seed (dropout and augmentation on) within the
  trainer tests' tolerances (``tests/test_torch_train.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusr.models.vgg as jvgg
import tpusr.tools.serving_gate as jsg
from test_torch_fixtures import NARROW_WIDTHS, to_numpy
from test_torch_train import LOSS_RTOL, _flat, assert_params_close
from tpusr.models import EDSR as JaxEDSR
from tpusr.models import SRCNN as JaxSRCNN
from tpusr.models import VGG16Classifier as JaxVGG16
from tpusr.models import VGG19Features as JaxVGG19
from tpusr.models.esrgan import ESRGANDiscriminator as JaxDisc
from tpusr.models.esrgan import ESRGANGenerator as JaxGen
from tpusr.train import ClassifierTrainer as JaxClassifierTrainer
from tpusr.train import SupervisedSRTrainer as JaxSRTrainer
import tpusr_torch.tools.serving_gate as tsg
from tpusr_torch.bridge import esrgan_generator_to_flax, to_flax_tree
from tpusr_torch.core import prng
from tpusr_torch.models import (EDSR, SRCNN, ESRGANDiscriminator,
                                ESRGANGenerator)
from tpusr_torch.models.init import NO_DRAW, ParamRng, dropout_key
from tpusr_torch.models.vgg import VGG16Classifier, VGG19Features
from tpusr_torch.train import ClassifierTrainer, SupervisedSRTrainer

SEEDS = (0, 1, 2, 7, 42, 123456, -1, 2 ** 31 - 1)
NORMAL_ULP = 0          # the normals' bound, in float32 ulp
NORMAL_APART = 0        # values allowed beyond it


def _j(a) -> np.ndarray:
    return np.asarray(a)


def _equal(got: torch.Tensor, want) -> None:
    want = _j(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


# --------------------------------------------------------------------- keys
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    assert key == prng.as_key(jk) == prng.as_key(seed)
    for n in (2, 3, 4, 8, 9):
        assert prng.split(key, n) == [prng.as_key(k)
                                      for k in jax.random.split(jk, n)]
    for data in (0, 1, 7, 99, 4999, 2 ** 31 + 5, 2 ** 32 - 1):
        assert prng.fold_in(key, data) == prng.as_key(
            jax.random.fold_in(jk, data))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 7), (4, 33, 2, 3)])
def test_bits_equal_jax(shape):
    for seed in (0, 5):
        _equal(prng.bits(prng.PRNGKey(seed), shape),
               _j(jax.random.bits(jax.random.PRNGKey(seed), shape)).astype(
                   np.int64))


# ------------------------------------------------------------------ samplers
UNIFORM_RANGES = [(0.0, 1.0), (0.3, 0.7), (0.0, np.pi), (32.0, 64.0),
                  (0.0, 2 * np.pi), (0.12, 0.25), (1.0, 1.0), (-20.0, 20.0),
                  (-0.2, 0.2), (0.8, 2.0), (2.0, 10.0), (-1.0, 1.0)]


@pytest.mark.parametrize("lo,hi", UNIFORM_RANGES)
def test_uniform_equals_jax(lo, hi):
    for seed, shape in ((3, ()), (4, (128,)), (5, (6, 17, 17, 1))):
        _equal(prng.uniform(prng.PRNGKey(seed), shape, lo, hi),
               jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                  minval=lo, maxval=hi))


RANDINT_RANGES = [(0, 1), (0, 3), (0, 4), (20, 60), (0, 2048), (0, 417),
                  (-5, 5), (5, 5), (0, 70000), (0, 2 ** 31 - 1),
                  (-2 ** 31, 2 ** 31 - 1)]


@pytest.mark.parametrize("lo,hi", RANDINT_RANGES)
def test_randint_equals_jax(lo, hi):
    for seed, shape in ((3, ()), (4, (64,)), (5, (1000,))):
        _equal(prng.randint(prng.PRNGKey(seed), shape, lo, hi),
               jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))


@pytest.mark.parametrize("p", [0.5, 0.8, 0.3])
def test_bernoulli_equals_jax(p):
    for seed, shape in ((3, (64,)), (4, (300, 50))):
        _equal(prng.bernoulli(prng.PRNGKey(seed), p, shape),
               jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape))


@pytest.mark.parametrize("n", [1, 2, 8, 24, 128, 5000])
def test_permutation_equals_jax(n):
    """n = 5000 takes two sort rounds (JAX's ceil(3 ln n / ln(2^32 - 1)))."""
    _equal(prng.permutation(prng.PRNGKey(6), n),
           jax.random.permutation(jax.random.PRNGKey(6), n))


def _ulps(got: torch.Tensor, want) -> np.ndarray:
    a = got.numpy().view(np.int32).astype(np.int64)
    b = _j(want).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_normal_and_truncated_normal_equal_jax(seed):
    """The computed path over 10^5 draws (every branch of XLA's log1p and
    erf_inv: |u| < 0.41 and above, w < 5 and above): NORMAL_ULP and
    NORMAL_APART."""
    key, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    shape = (100_003,)
    ulps = _ulps(prng.normal(key, shape), jax.random.normal(jk, shape))
    assert int((ulps > NORMAL_ULP).sum()) <= NORMAL_APART, int(ulps.max())
    ulps = _ulps(prng.truncated_normal(key, -2.0, 2.0, shape),
                 jax.random.truncated_normal(jk, -2.0, 2.0, shape))
    assert int((ulps > NORMAL_ULP).sum()) <= NORMAL_APART, int(ulps.max())


@pytest.mark.parametrize("sampler", ["normal", "truncated_normal"])
def test_large_normal_draws_use_the_table_and_equal_jax(sampler):
    """A draw of more than 2^20 values looks up the table of all 2^23
    mantissas, whose every entry is the computed path's (the truncated
    normal's at flax's bounds, as a large kernel draws it)."""
    shape = (3, 2 ** 19 + 7)
    key, jk = prng.PRNGKey(11), jax.random.PRNGKey(11)
    if sampler == "normal":
        bounds = (None, None)
        got = prng.normal(key, shape)
        want = jax.random.normal(jk, shape)
        assert torch.equal(prng.normal_erf_inv(key, shape) * prng.SQRT2, got)
    else:
        bounds = (-2.0, 2.0)
        got = prng.truncated_normal(key, *bounds, shape)
        want = jax.random.truncated_normal(jk, *bounds, shape)
    assert got.numel() >= prng._TABLE_MIN
    assert ("cpu",) + bounds in prng._TABLES
    ulps = _ulps(got, want)
    assert int((ulps > NORMAL_ULP).sum()) <= NORMAL_APART, int(ulps.max())


# ------------------------------------------------------------ flax key paths
def test_flax_param_and_dropout_keys():
    """A scope's keys: fold_in(root, sha1(names, counter)[:4]), as flax's
    ``LazyRng``; the dropout collection's first key per Dropout scope."""
    from flax.core.scope import LazyRng
    root = jax.random.PRNGKey(42)
    rng = ParamRng(root).child("res0").child("conv1")
    for count in (1, 2, 3):
        want = LazyRng.create(root, "res0", "conv1", count).as_jax_rng()
        assert rng.next() == prng.as_key(want)
    want = LazyRng.create(root, "Dropout_1", 1).as_jax_rng()
    assert dropout_key((0, 42), ("Dropout_1",)) == prng.as_key(want)


def test_no_draw_builds_zero_weights_of_the_drawn_shapes():
    """``key=NO_DRAW`` (the bridges' constructors, which load weights over
    the module's) draws nothing: every parameter and ``u`` is zero, at the
    shapes of a drawn model."""
    for build in (lambda k: EDSR(scale_factor=2, num_res_blocks=1,
                                 num_filters=8, device="cpu", key=k),
                  lambda k: ESRGANDiscriminator(device="cpu", key=k)):
        drawn, blank = build(3), build(NO_DRAW)
        want = dict(drawn.state_dict())
        got = dict(blank.state_dict())
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert all(not v.any() for v in got.values())
        assert any(v.any() for v in want.values())


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(to_numpy(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


def _init(module, key, shape) -> dict:
    """flax's ``init`` of ``module`` on zeros of ``shape``, compiled as one
    program (its draws are those of the eager ``init``, which is slower)."""
    return jax.jit(module.init)(key, jnp.zeros(shape))


def _narrow(monkeypatch, cfg: str) -> tuple:
    """JAX's VGG config ``cfg`` at NARROW_WIDTHS: flax's key paths and the
    draws' rules do not depend on the widths (the full widths' large
    kernels take the table path, held above)."""
    narrow = tuple((b, n, w) for (b, n, _f), w in zip(getattr(jvgg, cfg),
                                                      NARROW_WIDTHS))
    monkeypatch.setattr(jvgg, cfg, narrow)
    return NARROW_WIDTHS


def _params(model) -> dict:
    return to_flax_tree(dict(model.named_parameters()))


def test_edsr_x4_full_width_equals_flax_init():
    jk = jax.random.PRNGKey(42)
    want = _init(JaxEDSR(scale_factor=4), jk, (1, 4, 4, 3))["params"]
    _assert_trees_equal(_params(EDSR(scale_factor=4, device="cpu", key=jk)),
                        want)


def test_srcnn_equals_flax_init():
    jk = jax.random.PRNGKey(42)
    want = _init(JaxSRCNN(), jk, (1, 8, 8, 3))["params"]
    _assert_trees_equal(_params(SRCNN(device="cpu", key=42)), want)


@functools.cache
def _jax_vgg16_trainer():
    """JAX's ClassifierTrainer on VGG16 (narrow widths, 16 dense units) and
    its default ``init_state`` (flax's ``init`` at PRNGKey(42)), compiled
    once for the tests that hold the port to it."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, "_VGG16_CFG")
        jt = JaxClassifierTrainer(JaxVGG16(num_classes=2, dense_units=16),
                                  1e-3)
        # compiled as one program: the eager init draws the same, slower
        return jt, jax.jit(jt.init_state)(jnp.zeros((1, 32, 32, 3)))


def test_vgg16_classifier_equals_flax_init():
    """Built with no key: the JAX trainer's default draw."""
    _jt, st_j = _jax_vgg16_trainer()
    _assert_trees_equal(_params(VGG16Classifier(
        num_classes=2, dense_units=16, widths=NARROW_WIDTHS, device="cpu")),
        st_j.params)


def test_vgg19_features_equal_flax_init(monkeypatch):
    widths = _narrow(monkeypatch, "_VGG19_CFG")
    want = _init(JaxVGG19(), jax.random.PRNGKey(0), (1, 16, 16, 3))["params"]
    _assert_trees_equal(_params(VGG19Features(widths=widths, device="cpu",
                                              key=0)), want)


def test_esrgan_g8x4_and_discriminator_equal_flax_init():
    """Built with no key, the generator (growth 8, x4, its two attention
    sites) and the discriminator with its spectral ``u`` hold what the JAX
    GAN trainer's default ``init_state`` draws: the two keys of
    split(PRNGKey(42))."""
    rg, rd = jax.random.split(jax.random.PRNGKey(42))
    want = _init(JaxGen(scale_factor=4, growth_channels=8, num_rrdb_blocks=1),
                 rg, (1, 4, 4, 3))["params"]
    gen = ESRGANGenerator(scale_factor=4, growth_channels=8,
                          num_rrdb_blocks=1, device="cpu")
    _assert_trees_equal(esrgan_generator_to_flax(dict(gen.named_parameters())),
                        want)
    want = _init(JaxDisc(), rd, (1, 32, 32, 3))
    disc = ESRGANDiscriminator(device="cpu")
    _assert_trees_equal(_params(disc), want["params"])
    _assert_trees_equal(to_flax_tree(dict(disc.named_buffers())),
                        want["spectral"])


# ------------------------------------------------------- the gate's streams
@pytest.mark.parametrize("task", ["easy", "hard"])
def test_gate_surfaces_labels_and_crop_pools_equal_jax(task):
    """No draws carried in: the port's images within the tolerance of
    ``test_surface_images_from_jax_draws_match_jax`` (the image arithmetic
    is float32 in another order), its labels and crop offsets equal."""
    t = jsg.TASKS[task]
    want, want_labels = jsg.make_surface_images(
        3, 6, 64, t["amp_range"], t["noise"], t["coverage_range"])
    got, labels = tsg.make_surface_images(
        3, 6, 64, t["amp_range"], t["noise"], t["coverage_range"],
        device="cpu")
    np.testing.assert_array_equal(labels.numpy(), _j(want_labels))
    np.testing.assert_array_equal(tsg.surface_labels(3, 6),
                                  jsg.surface_labels(3, 6))
    assert float(np.abs(got.numpy() - _j(want)).max()) <= 1e-6
    crops_j, lab_j, offs_j = jsg.make_crop_pool(
        5, jnp.asarray(got.numpy()), jnp.asarray(labels.numpy()), 40, 24,
        align=4)
    crops, lab, offs = tsg.make_crop_pool(5, got, labels, 40, 24, align=4)
    for a, b in zip(offs, offs_j):
        np.testing.assert_array_equal(a.numpy(), _j(b))
    np.testing.assert_array_equal(lab.numpy(), _j(lab_j))
    np.testing.assert_array_equal(crops.numpy(), _j(crops_j))


# ------------------------------------------------ trainers from a bare seed
def test_classifier_steps_from_a_bare_seed_equal_jax(monkeypatch):
    """VGG16 (narrow widths, dropout 0.2) built with no key and the JAX
    trainer's default ``init_state`` (PRNGKey(42)), three steps with the
    augmentation on: the same initial weights bit for bit, then the
    trainer tests' tolerances (losses rtol 1e-4, parameters per
    ``assert_params_close``)."""
    widths = _narrow(monkeypatch, "_VGG16_CFG")
    rng = np.random.default_rng(8)
    xs = rng.random((3, 4, 32, 32, 3), dtype=np.float32)
    ys = rng.integers(0, 2, (3, 4)).astype(np.int32)
    w = np.ones(4, np.float32)
    jt, st_j = _jax_vgg16_trainer()
    pt = ClassifierTrainer(VGG16Classifier(num_classes=2, dense_units=16,
                                           widths=widths, device="cpu"),
                           1e-3, device="cpu")
    st_t = pt.init_state()
    _assert_trees_equal(to_flax_tree(st_t.params), st_j.params)
    for step in range(3):
        st_j, m_j = jt._train_step_w(st_j, jnp.asarray(xs[step]),
                                     jnp.asarray(ys[step]), jnp.asarray(w),
                                     step, True)
        st_t, m_t = pt._train_step_w(st_t, torch.from_numpy(xs[step]),
                                     torch.from_numpy(ys[step]),
                                     torch.from_numpy(w), step, True)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{k} {step}")
    assert_params_close(_flat(to_flax_tree(st_t.params)),
                        _flat(to_numpy(st_j.params)))


def test_sr_steps_from_a_bare_seed_equal_jax():
    """EDSR x2 (two blocks of 8 filters) built with no key and the JAX
    trainer's default ``init_state`` (PRNGKey(42)), three steps: equal
    initial weights, then the trainer tests' tolerances."""
    rng = np.random.default_rng(9)
    xs = rng.random((3, 4, 8, 8, 3), dtype=np.float32)
    ys = rng.random((3, 4, 16, 16, 3), dtype=np.float32)
    arch = dict(scale_factor=2, num_res_blocks=2, num_filters=8)
    jt = JaxSRTrainer(JaxEDSR(**arch), 1e-3)
    st_j = jax.jit(jt.init_state)(jnp.asarray(xs[0][:1]))
    pt = SupervisedSRTrainer(EDSR(**arch, device="cpu"), 1e-3, device="cpu")
    st_t = pt.init_state()
    _assert_trees_equal(to_flax_tree(st_t.params), st_j.params)
    for step in range(3):
        st_j, m_j = jt.train_step(st_j, jnp.asarray(xs[step]),
                                  jnp.asarray(ys[step]))
        st_t, m_t = pt.train_step(st_t, torch.from_numpy(xs[step]),
                                  torch.from_numpy(ys[step]))
        for k in ("loss", "psnr", "ssim"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{k} {step}")
    assert_params_close(_flat(to_flax_tree(st_t.params)),
                        _flat(to_numpy(st_j.params)))
