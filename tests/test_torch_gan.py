"""The port's adversarial ESRGAN trainer (tpusr_torch/train/gan.py) and the
``ESRGAN`` facade against the JAX package's (tpusr/train/gan.py,
tpusr/models/api.py) on the CPU, from the same weights and the same numpy
batches: a generator at growth 4, 1 RRDB, x2 (LR 8^2 -> HR 16^2), the
spectral-norm discriminator and the full VGG19 to ``block5_conv4`` at 16^2.

The weights are drawn by the port's initialisers and handed to JAX as flax
trees (``_flax_trees``; ``tpusr_torch.bridge`` is their inverse, held by
``test_the_trees_round_trip_through_the_bridge``).

Tolerances, each stated where it is used:
- ``_bce``, ``pixel_l1``, ``spectral_l1``: 1e-6 relative;
- gradients: ``max|dg| <= 1e-5 * max|g|`` per leaf (float32 sums in another
  order than XLA's);
- the spectral-norm ``u`` after a D step: 1e-6 absolute (unit vectors);
- losses and metrics over 3 steps: rtol 1e-4;
- bf16 steps: ``BF16_DEPTH * 2^-8`` relative (see ``test_bf16_step``).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpusr.train.gan as jgan
from test_torch_cli import narrow_models
from test_torch_fixtures import NARROW_WIDTHS, vgg_layers, write_notop_h5
from tpusr.models.esrgan import ESRGANDiscriminator as JaxDisc
from tpusr.models.esrgan import ESRGANGenerator as JaxGen
from tpusr.models.vgg import VGG19Features as JaxVGG19
from tpusr.models.vgg import load_keras_h5_weights as jload_h5
from tpusr.train import keras_import as jki
from tpusr_torch.bridge import esrgan_generator_to_flax, to_flax_tree
from tpusr_torch.bridge import (esrgan_discriminator_from_flax,
                                esrgan_generator_from_flax,
                                vgg19_features_from_flax)
from tpusr_torch.core import conv3x3
from tpusr_torch.models.api import ESRGAN
from tpusr_torch.models.esrgan import ESRGANDiscriminator, ESRGANGenerator
from tpusr_torch.models.vgg import VGG19Features
from tpusr_torch.pipeline.png import decode_png_u8
from tpusr_torch.train import gan
from tpusr_torch.train.gan import ESRGANTrainer

FN_RTOL = 1e-6
GRAD_RTOL = 1e-5
U_ATOL = 1e-6
LOSS_RTOL = 1e-4
STEPS = 3
BF16_UNIT = 2.0 ** -8
# bf16 roundings on the deepest path of the G loss: the generator's 1 + 15
# + 1 convs, two attentions and 3 convs of the tail, then VGG19's 16 convs
BF16_DEPTH = 1 + 15 + 1 + 2 + 3 + 16


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _nested(named: dict) -> dict:
    """Port names -> a nested flax tree of numpy arrays (the ESRGAN modules
    keep flax's layouts; the attention's 1x1 kernels get their unit axes)."""
    tree: dict = {}
    for name, t in named.items():
        a = t.detach().cpu().numpy().copy()
        *path, leaf = name.split(".")
        if leaf == "kernel" and a.ndim == 2 and "self_attention" in name:
            a = a[None, None]
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a
    return tree


def _flax_trees(gen, disc, vgg):
    g = _nested(dict(gen.named_parameters()))
    d = _nested(dict(disc.named_parameters()))
    spec = _nested(dict(disc.named_buffers()))
    v = to_flax_tree(dict(vgg.named_parameters()))
    return g, d, spec, v


def _with_random_biases(module, rng):
    """Biases drawn at random (the initialisers zero them, which would leave
    the bias paths untested)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(
                    (rng.standard_normal(p.shape) * 0.05).astype(np.float32)))
    return module


def _jax_state(jt, g, d, spec):
    g, d, spec = (jax.tree.map(jnp.asarray, t) for t in (g, d, spec))
    return jgan.GANState(g_params=g, d_params=d, d_spectral=spec,
                         g_opt=jt.g_tx.init(g), d_opt=jt.d_tx.init(d),
                         step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    gen = _with_random_biases(ESRGANGenerator(
        scale_factor=2, growth_channels=4, num_rrdb_blocks=1, device="cpu",
        generator=torch.Generator().manual_seed(1)), rng)
    disc = _with_random_biases(ESRGANDiscriminator(
        device="cpu", generator=torch.Generator().manual_seed(2)), rng)
    vgg = VGG19Features(device="cpu", generator=torch.Generator().manual_seed(3))
    g, d, spec, v = _flax_trees(gen, disc, vgg)
    lr = (rng.random((STEPS, 4, 8, 8, 3), dtype=np.float32) * 2 - 1)
    hr = (rng.random((STEPS, 4, 16, 16, 3), dtype=np.float32) * 2 - 1)
    jg = JaxGen(scale_factor=2, growth_channels=4, num_rrdb_blocks=1)
    jd = JaxDisc()
    jt = jgan.ESRGANTrainer(jg, jd, JaxVGG19(), jax.tree.map(jnp.asarray, v))
    return types.SimpleNamespace(gen=gen, disc=disc, vgg=vgg, g=g, d=d,
                                 spec=spec, v=v, lr=lr, hr=hr, jg=jg, jd=jd,
                                 jt=jt)


def _port(case, **kw):
    return ESRGANTrainer(case.gen, case.disc, case.vgg, device="cpu", **kw)


def test_the_trees_round_trip_through_the_bridge(case):
    gen = esrgan_generator_from_flax(case.g, device="cpu")
    disc = esrgan_discriminator_from_flax(case.d, case.spec, device="cpu")
    vgg = vgg19_features_from_flax(case.v, device="cpu")
    for a, b in ((gen, case.gen), (disc, case.disc), (vgg, case.vgg)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


# ------------------------------------------------------------ loss terms

@pytest.mark.parametrize("shape", [(2, 6, 10, 3), (3, 16, 16, 3)])
def test_loss_terms_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape, dtype=np.float32) * 2 - 1
    b = rng.random(shape, dtype=np.float32) * 2 - 1
    p = rng.random((shape[0], 1), dtype=np.float32)
    p[0, 0], p[-1, 0] = 0.0, 1.0              # both clip bounds
    ta, tb, tp = map(torch.from_numpy, (a, b, p))
    for got, want in (
            (gan._bce(torch.ones_like(tp), tp),
             jgan._bce(jnp.ones_like(p), jnp.asarray(p))),
            (gan._bce(torch.zeros_like(tp), tp),
             jgan._bce(jnp.zeros_like(p), jnp.asarray(p))),
            (gan.pixel_l1(ta, tb), jgan.pixel_l1(jnp.asarray(a), jnp.asarray(b))),
            (gan.spectral_l1(ta, tb),
             jgan.spectral_l1(jnp.asarray(a), jnp.asarray(b)))):
        np.testing.assert_allclose(float(got), float(want), rtol=FN_RTOL)


def test_spectral_l1_runs_over_the_trailing_w_c_axes():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((2, 8, 6, 3), dtype=np.float32))
    b = torch.from_numpy(rng.random((2, 8, 6, 3), dtype=np.float32))

    def over(dims):
        fa = torch.fft.fft2(a.to(torch.complex64), dim=dims).abs()
        fb = torch.fft.fft2(b.to(torch.complex64), dim=dims).abs()
        return float((fa - fb).abs().mean())
    got = float(gan.spectral_l1(a, b))
    assert got == over((-2, -1))
    assert abs(got - over((1, 2))) > 1e-3 * got       # not over (H, W)


@pytest.mark.parametrize("k", [3, 10000])
def test_staircase_rate_is_optax_exponential_decay(k):
    for init in (1e-4, 1e-5, 3e-3):
        sched = optax.exponential_decay(init, k, 0.5, staircase=True)
        for count in (0, k - 1, k, 2 * k, 5 * k + 1):
            want = float(sched(jnp.asarray(count, jnp.int32)))
            assert gan.staircase_lr(init, k, 0.5, count) == want, (init, count)
    tr = ESRGANTrainer(ESRGANGenerator(2, 4, 1, device="cpu"),
                       ESRGANDiscriminator(device="cpu"),
                       VGG19Features(widths=(4, 4, 4, 4, 4), device="cpu"),
                       decay_steps=k, device="cpu")
    jt = jgan.ESRGANTrainer(None, None, None, None, decay_steps=k)
    for count in (0, k - 1, k, 2 * k):
        assert tr.g_sched(count) == float(jt.g_sched(count))
        assert tr.d_sched(count) == float(jt.d_sched(count))


# ------------------------------------------------------------ gradients

def test_d_loss_gradients_and_the_new_u_match_jax(case):
    lr, hr = case.lr[0], case.hr[0]
    jg, jd = case.jg, case.jd
    g = jax.tree.map(jnp.asarray, case.g)

    def d_loss_fn(d_params, spectral):          # the JAX step's D loss
        fake = jg.apply({"params": g}, jnp.asarray(lr))
        d_real, mut = jd.apply({"params": d_params, "spectral": spectral},
                               jnp.asarray(hr), True, mutable=["spectral"])
        d_fake = jd.apply({"params": d_params, "spectral": mut["spectral"]},
                          fake)
        loss = (jgan._bce(jnp.ones_like(d_real), d_real)
                + jgan._bce(jnp.zeros_like(d_fake), d_fake))
        return loss, mut["spectral"]
    (loss_j, u_j), g_j = jax.jit(jax.value_and_grad(d_loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, case.d), jax.tree.map(jnp.asarray, case.spec))

    pt = _port(case)
    st = pt.init_state()
    with torch.enable_grad():
        fake = pt._generate(st.g_params, torch.from_numpy(lr))
        loss_t = pt.d_loss(st.d_params, st.d_spectral, fake.detach(),
                           torch.from_numpy(hr))
        grads = torch.autograd.grad(loss_t, list(st.d_params.values()))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=FN_RTOL)
    got = _flat(_nested(dict(zip(st.d_params, grads))))
    want = _flat(jax.tree.map(np.asarray, g_j))
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= GRAD_RTOL * np.abs(w).max(), path
    u_t = _flat(_nested(st.d_spectral))
    for path, w in _flat(jax.tree.map(np.asarray, u_j)).items():
        np.testing.assert_allclose(u_t[path], w, atol=U_ATOL, rtol=0)
        assert not np.allclose(w, _flat(case.spec)[path], atol=U_ATOL)


def test_g_loss_components_and_gradients_match_jax(case):
    lr, hr = case.lr[1], case.hr[1]
    jt = case.jt
    args = [jax.tree.map(jnp.asarray, t) for t in (case.d, case.spec)]

    def f(g_params):
        total, aux = jt.g_loss_components(g_params, *args, jnp.asarray(lr),
                                          jnp.asarray(hr))
        return total, {k: v for k, v in aux.items() if k != "fake"}
    (tot_j, aux_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, case.g))

    pt = _port(case)
    st = pt.init_state()
    with torch.enable_grad():
        tot_t, aux_t = pt.g_loss_components(
            st.g_params, st.d_params, st.d_spectral, torch.from_numpy(lr),
            torch.from_numpy(hr))
        grads = torch.autograd.grad(tot_t, list(st.g_params.values()))
    np.testing.assert_allclose(tot_t.item(), float(tot_j), rtol=LOSS_RTOL)
    for k in ("adv", "perc", "pixel", "spec"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got = _flat(_nested(dict(zip(st.g_params, grads))))
    want = _flat(jax.tree.map(np.asarray, g_j))
    assert set(got) == set(want)
    for path, w in want.items():
        scale = np.abs(w).max()
        if path[1:] == ("f", "bias"):
            # softmax(g f^T) is invariant to a bias shared by every key, so
            # this gradient is 0 in exact arithmetic and both sides hold
            # rounding only: held at the scale of the same layer's kernel
            scale = np.abs(want[path[:2] + ("kernel",)]).max()
            assert np.abs(w).max() <= GRAD_RTOL * scale, path
        assert np.abs(got[path] - w).max() <= GRAD_RTOL * scale, (
            path, float(np.abs(got[path] - w).max()), float(scale))


# ------------------------------------------------------------ steps

def _steps(trainer, state, case, n=STEPS, jax_side=False):
    out = []
    for i in range(n):
        if jax_side:
            state, m = trainer.train_step(state, jnp.asarray(case.lr[i]),
                                          jnp.asarray(case.hr[i]))
        else:
            state, m = trainer.train_step(state, torch.from_numpy(case.lr[i]),
                                          torch.from_numpy(case.hr[i]))
        out.append({k: float(v) for k, v in m.items()})
    return state, out


@pytest.fixture(scope="module")
def jax_steps(case):
    jt = case.jt
    st, ms = _steps(jt, _jax_state(jt, case.g, case.d, case.spec), case,
                    jax_side=True)
    return st, ms


def test_three_steps_match_jax(case, jax_steps):
    st_j, ms_j = jax_steps
    pt = _port(case)
    conv3x3.reset_launch_counts()
    st_t, ms_t = _steps(pt, pt.init_state(), case)
    assert sum(conv3x3.LAUNCHES.values()) == 0         # the twin on the CPU
    for i, (mt, mj) in enumerate(zip(ms_t, ms_j)):
        assert set(mt) == set(mj) == {"g_loss", "d_loss", "psnr", "ssim"}
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], rtol=LOSS_RTOL,
                                       err_msg=f"{k} step {i}")
    assert st_t.step == STEPS == int(st_j.step)
    assert st_t.g_opt["count"] == st_t.d_opt["count"] == STEPS
    u_t = _flat(_nested(st_t.d_spectral))
    for path, w in _flat(jax.tree.map(np.asarray, st_j.d_spectral)).items():
        np.testing.assert_allclose(u_t[path], w, atol=U_ATOL, rtol=0)
    # master weights, moments and the spectral vectors stay float32
    for tree in (st_t.g_params, st_t.d_params, st_t.d_spectral,
                 st_t.g_opt["mu"], st_t.d_opt["nu"]):
        assert all(v.dtype == torch.float32 for v in tree.values())
    ev_j = case.jt.val_step(st_j, jnp.asarray(case.lr[0]),
                            jnp.asarray(case.hr[0]))
    ev_t = pt.val_step(st_t, torch.from_numpy(case.lr[0]),
                       torch.from_numpy(case.hr[0]))
    for k in ("g_loss", "psnr", "ssim"):
        np.testing.assert_allclose(float(ev_t[k]), float(ev_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_remat_is_bit_for_bit_the_same_step(case):
    runs = {}
    for remat in (False, True):
        pt = _port(case, remat=remat)
        st, ms = _steps(pt, pt.init_state(), case, n=2)
        runs[remat] = (st, ms)
    (a, ma), (b, mb) = runs[False], runs[True]
    assert ma == mb
    for tree in ("g_params", "d_params", "d_spectral"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        assert all(torch.equal(ta[k], tb[k]) for k in ta), tree
    assert all(torch.equal(a.g_opt["nu"][k], b.g_opt["nu"][k])
               for k in a.g_opt["nu"])


def test_bf16_step(case):
    """One bf16 step of the port against one of JAX's, from the same state
    and batch. Every bf16 rounding (unit 2^-8) on the way to a loss can move
    it by that share of its size to first order, and a G-loss path passes
    at most ``BF16_DEPTH`` of them, so the two steps' losses agree within
    ``BF16_DEPTH * 2^-8`` relative. The port's bf16 step differs from its
    own float32 step (so bf16 ran), while the parameters, moments and the
    discriminator stay float32."""
    jt = jgan.ESRGANTrainer(case.jg, case.jd, JaxVGG19(),
                            jax.tree.map(jnp.asarray, case.v),
                            compute_dtype="bfloat16")
    _, (m_j,) = _steps(jt, _jax_state(jt, case.g, case.d, case.spec), case,
                       n=1, jax_side=True)
    pt = _port(case, compute_dtype="bfloat16")
    st, (m_t,) = _steps(pt, pt.init_state(), case, n=1)
    f32 = _port(case)
    _, (m_f,) = _steps(f32, f32.init_state(), case, n=1)
    for k in ("g_loss", "d_loss", "psnr"):
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=BF16_DEPTH * BF16_UNIT,
                                   err_msg=k)
    assert m_t["g_loss"] != m_f["g_loss"]
    for tree in (st.g_params, st.d_params, st.d_spectral, st.g_opt["mu"]):
        assert all(v.dtype == torch.float32 for v in tree.values())
    assert pt._vgg_in["vgg19.block1_conv1.weight"].dtype == torch.bfloat16


def test_mesh_raises_naming_its_item(case):
    # data parallelism is ported (tests/test_torch_dist_sharding.py); a
    # mesh that is not a DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        _port(case, mesh=object())
    with pytest.raises(ValueError, match="bfloat16"):
        _port(case, compute_dtype="float16")


# ------------------------------------------------------------ fit, evaluate

def _recording(trainer, seen, jax_side):
    """``trainer.train_step`` replaced by one that records each batch's
    first pixel (the data index) and returns the state unchanged."""
    def step(state, xb, yb):
        seen.append(np.asarray(xb)[:, 0, 0, 0].copy())
        zero = jnp.float32(0) if jax_side else torch.zeros(())
        return state, {"g_loss": zero, "d_loss": zero, "psnr": zero,
                       "ssim": zero}
    trainer.train_step = step


@pytest.mark.parametrize("n,batch,spe", [(10, 4, None), (10, 3, 5), (3, 4, 2)])
def test_fit_draws_the_batches_jax_draws(case, n, batch, spe):
    # image i is all i / 16 (exact in float32, and after x * 2 - 1)
    x = np.broadcast_to(np.arange(n, dtype=np.float32)[:, None, None, None] / 16,
                        (n, 8, 8, 3)).copy()
    y = np.zeros((n, 16, 16, 3), np.float32)
    jt = jgan.ESRGANTrainer(case.jg, case.jd, JaxVGG19(), None)
    seen_j, seen_t = [], []
    _recording(jt, seen_j, True)
    st_j = _jax_state(jt, case.g, case.d, case.spec)
    jt.fit(x, y, epochs=3, batch_size=batch, steps_per_epoch=spe, seed=7,
           verbose=False, state=st_j)
    pt = _port(case)
    _recording(pt, seen_t, False)
    res = pt.fit(x, y, epochs=3, batch_size=batch, steps_per_epoch=spe,
                 seed=7, verbose=False, state=pt.init_state())
    assert len(seen_t) == len(seen_j) == 3 * (spe or max(1, n // batch))
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
    assert set(res.epoch_losses) == {"g_loss", "d_loss", "psnr", "ssim",
                                     "g_lr", "d_lr"}


def test_fit_history_evaluate_and_checkpoints(case, tmp_path):
    """Two epochs against JAX's fit from the same state (losses, validation
    on a set with a partial tail, rates), a checkpoint each epoch restored
    to the last state, and ``evaluate`` on a test set smaller than the
    batch."""
    from tpusr_torch.train import restore_checkpoint
    rng = np.random.default_rng(8)
    y = rng.random((9, 16, 16, 3), dtype=np.float32)
    x = y.reshape(9, 8, 2, 8, 2, 3).mean(axis=(2, 4))
    kw = dict(epochs=2, batch_size=4, seed=5, verbose=False)
    res_j = case.jt.fit(x[:6], y[:6], x[6:], y[6:],
                        state=_jax_state(case.jt, case.g, case.d, case.spec),
                        **kw)
    pt = _port(case)
    res_t = pt.fit(x[:6], y[:6], x[6:], y[6:], state=pt.init_state(),
                   checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    h_j, h_t = res_j.epoch_losses, res_t.epoch_losses
    assert set(h_t) == set(h_j)
    for k in h_j:
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=LOSS_RTOL, err_msg=k)
    assert h_t["g_lr"] == [float(v) for v in h_j["g_lr"]]
    assert len(res_t.time_tracker.epoch_times_sec) == 2
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert saved == ["epoch_0001", "epoch_0001.meta.json", "epoch_0002",
                     "epoch_0002.meta.json"]
    back = restore_checkpoint(str(tmp_path), "epoch_0002", pt.init_state())
    assert back.step == 2 and back.g_opt["count"] == 2
    for tree in ("g_params", "d_params", "d_spectral"):
        a, b = getattr(back, tree), getattr(res_t.state, tree)
        assert all(torch.equal(a[k], b[k]) for k in a), tree
    ev_j = case.jt.evaluate(res_j.state, x[:3], y[:3], batch_size=16)
    ev_t = pt.evaluate(res_t.state, x[:3], y[:3], batch_size=16)
    assert set(ev_t) == {"avg_psnr", "avg_ssim", "avg_g_loss"}
    for k in ev_j:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=LOSS_RTOL, err_msg=k)


def test_preview_grid_png_decodes_to_jax_pil_grid(case, tmp_path):
    """With the same SR in both packages (a 2x nearest upsample stands in
    for the generator) the decoded grids are equal; with the generators
    themselves within one level of 255."""
    from PIL import Image
    rng = np.random.default_rng(9)
    preview = rng.random((7, 8, 8, 3), dtype=np.float32)
    st_j = _jax_state(case.jt, case.g, case.d, case.spec)
    pt = _port(case)
    st_t = pt.init_state()

    def grids(tag):
        case.jt._save_sr_grid(st_j, preview, str(tmp_path / f"j{tag}"), 1, True)
        pt._save_sr_grid(st_t, preview, str(tmp_path / f"t{tag}"), 1, True)
        name = "epoch_001_sr_grid.png"
        with Image.open(tmp_path / f"j{tag}" / name) as im:
            want = np.asarray(im)
        got = decode_png_u8((tmp_path / f"t{tag}" / name).read_bytes())
        assert got.shape == want.shape == (80, 80, 3)
        return got.astype(int), want.astype(int)

    got, want = grids("gen")
    assert np.abs(got - want).max() <= 1
    assert got[40:].max() == 0                     # rows 3-4 of the grid empty
    case.jt._preview_fn = lambda p, x: jnp.repeat(jnp.repeat(x, 2, 1), 2, 2)
    pt._preview = lambda p, x: x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    try:
        got, want = grids("nearest")
    finally:
        del case.jt._preview_fn
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the facade

def test_esrgan_facade_lifecycle_and_round_trip(tmp_path):
    rng = np.random.default_rng(10)
    y = rng.random((6, 16, 16, 3), dtype=np.float32)
    x = y.reshape(6, 8, 2, 8, 2, 3).mean(axis=(2, 4))
    m = ESRGAN(device="cpu")
    with pytest.raises(RuntimeError, match="trained"):
        m.evaluate(x, y)
    m.setup_model(growth_channels=4, num_rrdb_blocks=1, input_shape=(8, 8, 3),
                  output_shape=(16, 16, 3))
    assert m.trainer.vgg_features.vgg19.until == "block5_conv4"
    hist, tt, mt = m.fit(x[:4], y[:4], x[4:], y[4:], epochs=1, batch_size=2)
    assert np.isfinite(hist["g_loss"]).all() and len(tt.epoch_times_sec) == 1
    ev = m.evaluate(x[4:], y[4:], batch_size=16)
    assert all(np.isfinite(v) for v in ev.values())
    lr_img = rng.random((12, 12, 3), dtype=np.float32)
    sr, _ = m.super_resolve_image(lr_img, patch_size_lr=8, stride=4)
    full, _ = m.super_resolve_full_image(lr_img)
    assert sr.shape == full.shape == (24, 24, 3)
    path = m.save(str(tmp_path), "t")
    m2 = ESRGAN(device="cpu")
    m2.setup_model(from_trained=True, generator_pretrained_path=path,
                   input_shape=(8, 8, 3))      # the arch comes from the sidecar
    assert m2._arch == m._arch and m2.output_shape == (16, 16, 3)
    for tree in ("g_params", "d_params", "d_spectral"):
        a, b = getattr(m2.state, tree), getattr(m.state, tree)
        assert all(torch.equal(a[k], b[k]) for k in a), tree
    assert m2.state.step == m.state.step == 2
    np.testing.assert_array_equal(
        m2.super_resolve_image(lr_img, patch_size_lr=8, stride=4)[0], sr)
    np.testing.assert_array_equal(m2.super_resolve_full_image(lr_img)[0], full)


def test_esrgan_facade_paths_not_ported_raise(tmp_path, monkeypatch):
    """The facade's ``save_h5`` (generator + discriminator) read back by
    JAX's importers as the facade's weights and ``u``; ``from_trained`` on
    the two files restores them; a missing discriminator or generator is a
    FileNotFoundError; a VGG19 notop ``.h5`` loads as JAX's loader does."""
    narrow_models(monkeypatch)
    m = ESRGAN(device="cpu")
    kw = dict(growth_channels=4, num_rrdb_blocks=1, input_shape=(8, 8, 3),
              output_shape=(16, 16, 3))
    m.setup_model(**kw)
    m.trained = True
    g_h5, d_h5 = m.save_h5(str(tmp_path), "t")
    g_tree = esrgan_generator_to_flax(m.state.g_params)
    d_tree, s_tree = (to_flax_tree(m.state.d_params),
                      to_flax_tree(m.state.d_spectral))
    zeros = functools.partial(jax.tree.map, np.zeros_like)
    back_g = jki.import_esrgan_generator(zeros(g_tree), g_h5)
    back_d, back_s = jki.import_esrgan_discriminator(zeros(d_tree),
                                                     zeros(s_tree), d_h5)
    for got, want in ((back_g, g_tree), (back_d, d_tree), (back_s, s_tree)):
        assert jax.tree.all(jax.tree.map(
            lambda a, b: np.array_equal(np.asarray(a), b), got, want))
    m2 = ESRGAN(device="cpu")
    m2.setup_model(from_trained=True, generator_pretrained_path=g_h5,
                   discriminator_pretrained_path=d_h5, **kw)
    for tree in ("g_params", "d_params", "d_spectral"):
        a, b = getattr(m2.state, tree), getattr(m.state, tree)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), tree
    with pytest.raises(FileNotFoundError, match="Discriminator"):
        m2.setup_model(from_trained=True, generator_pretrained_path=g_h5,
                       **kw)
    with pytest.raises(FileNotFoundError):
        m.setup_model(from_trained=True,
                      generator_pretrained_path=str(tmp_path / "none"), **kw)
    layers = vgg_layers("vgg19", 2, NARROW_WIDTHS)
    notop = write_notop_h5(tmp_path / "vgg19_notop.h5", layers)
    m.setup_model(vgg19_weights_path=notop, **kw)
    template = {"vgg19": {n: {k: np.zeros_like(a) for k, a in v.items()}
                          for n, v in layers.items()}}
    want = jload_h5(template, notop, "vgg19")["vgg19"]
    got = to_flax_tree(dict(m.vgg_model.named_parameters()))["vgg19"]
    assert all(np.array_equal(got[n][k], np.asarray(want[n][k]))
               for n in want for k in ("kernel", "bias"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ESRGAN(mesh=object(), device="cpu").setup_model(**kw)