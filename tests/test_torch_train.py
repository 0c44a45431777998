"""The port's training path (tpusr_torch/train, the K2 autograd Function,
the trainable EDSR, SRCNN, VGG16 with dropout) against the JAX package's
trainers (tpusr/train/trainer.py) on the CPU, from the same bridged weights
and the same numpy batches.

Tolerances, each stated where it is used:
- gradients: ``max|dg| <= 1e-5 * max|g|`` per leaf (float32 sums in
  another order than XLA's);
- losses and metrics over 3 steps: rtol 1e-4;
- parameters after ``steps`` Adam steps at rate ``lr``: within
  ``2 * steps * lr`` everywhere (Adam's first steps are near sign(g), so a
  gradient that is ~0 in both may step either way), and within ``1e-3 * lr``
  for at least 99.9% of the elements.
"""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

import tpusr.models.vgg as jvgg
from test_torch_fixtures import NARROW_WIDTHS, edsr_tree, to_numpy, vgg16_tree
from tpusr.models import EDSR as JaxEDSR
from tpusr.models import SRCNN as JaxSRCNN
from tpusr.models import VGG16Classifier as JaxVGG16
from tpusr.train import ClassifierTrainer as JaxClassifierTrainer
from tpusr.train import SupervisedSRTrainer as JaxSRTrainer
from tpusr_torch.bridge import (edsr_from_flax, flax_path, srcnn_from_flax,
                                to_flax_tree, vgg16_from_flax)
from tpusr_torch.core import conv3x3
from tpusr_torch.core.conv3x3 import conv3x3_bias_act_train
from tpusr_torch.models import EDSR, SRCNN, VGG16Classifier
from tpusr_torch.train import ClassifierTrainer, SupervisedSRTrainer

GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-4
LR = 1e-3
STEPS = 3


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_grads_close(got: dict, want: dict):
    """``got``/``want``: flax path -> array; max|dg| <= 1e-5 max|g| per leaf."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= GRAD_RTOL * scale, (
            path, float(np.abs(g - w).max()), float(scale))


def assert_params_close(got: dict, want: dict, steps=STEPS, lr=LR):
    diffs = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert diffs.max() <= 2 * steps * lr, float(diffs.max())
    assert np.mean(diffs <= 1e-3 * lr) >= 0.999, np.mean(diffs <= 1e-3 * lr)


# ------------------------------------------------------------------ K2 Function

@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 7, 9, 5, 6), (1, 6, 6, 16, 3)])
def test_k2_function_gradients_match_jax_grad_of_the_flax_conv(shape, relu):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape) + relu)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    k[..., 0] = 0.0          # channel 0 is exactly 0 before the ReLU: the
    b[0] = 0.0               # tie, where jax.nn.relu's gradient is 0
    dy = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    conv = fnn.Conv(cout, (3, 3), padding="SAME")

    def f(x_, k_, b_):
        y = conv.apply({"params": {"kernel": k_, "bias": b_}}, x_)
        return jax.nn.relu(y) if relu else y

    y_j, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    want = dict(zip(("x", "kernel", "bias"), map(np.asarray, vjp(jnp.asarray(dy)))))

    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    conv3x3.reset_launch_counts()
    y = conv3x3_bias_act_train(xt, kt, bt, relu)
    y.backward(torch.from_numpy(dy))
    assert sum(conv3x3.LAUNCHES.values()) == 0        # the CPU runs the twin
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    got = {"x": xt.grad.numpy(), "kernel": kt.grad.numpy(), "bias": bt.grad.numpy()}
    assert_grads_close({(k_,): v for k_, v in got.items()},
                       {(k_,): v for k_, v in want.items()})
    if relu:   # the tie channel gets no gradient into its bias
        assert got["bias"][0] == 0.0 == want["bias"][0]


def test_k2_function_skips_dx_for_data_and_refuses_bf16():
    """dX is skipped for data. bfloat16 now trains on K2-bf16
    (``test_k2_function_bf16_gradients``); the Function refuses any other
    dtype, float16 here."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 5, 5, 3)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
    k.requires_grad_()
    b = torch.zeros(4, requires_grad=True)
    conv3x3_bias_act_train(x, k, b).sum().backward()
    assert x.grad is None and k.grad is not None and b.grad is not None
    np.testing.assert_allclose(b.grad.numpy(), np.full(4, 25.0))
    with pytest.raises(TypeError, match="bfloat16"):
        conv3x3_bias_act_train(x.half(), k.detach().half(), b)


BF16_UNIT = 2.0 ** -8     # bf16's unit roundoff (8 significant bits)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 7, 8, 16), (1, 5, 5, 3, 8)])
def test_k2_function_bf16_gradients(shape, relu):
    """The bf16 Function against float64 autograd on the same bf16-exact
    values, through the Function's own ReLU mask: dX and dW are one fp32
    sum each, rounded once to bf16, so within 1 bf16 rounding (2^-8
    relative) plus the fp32 sum's (K * 2^-23) of sum |dY||k| (dX) or
    sum |x||dY| (dW); db is summed in fp32 and returned in fp32. Every
    gradient has its input's dtype."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape) + relu)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32)).bfloat16()
    k = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.3)
                         .astype(np.float32)).bfloat16()
    b = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((n, h, w, cout)).astype(
        np.float32)).bfloat16()
    xt, kt, bt = (t.clone().requires_grad_() for t in (x, k, b))
    y = conv3x3_bias_act_train(xt, kt, bt, relu)
    assert y.dtype == torch.bfloat16
    y.backward(dy)
    assert (xt.grad.dtype, kt.grad.dtype, bt.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)
    g = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    xd, kd = (t.double().requires_grad_() for t in (x, k))
    zero = torch.zeros(cout, dtype=torch.float64)
    conv3x3.conv3x3_bias_act_plain(xd, kd, zero).backward(g.double())
    # sum |dY||k| per dX value and sum |x||dY| per dW value, in float64
    k_t = k.double().abs().flip(0, 1).transpose(2, 3)
    s_dx = conv3x3.conv3x3_bias_act_plain(g.double().abs(), k_t,
                                          torch.zeros(cin, dtype=torch.float64))
    s_dw = torch.nn.grad.conv2d_weight(
        x.double().abs().permute(0, 3, 1, 2), (cout, cin, 3, 3),
        g.double().abs().permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
    for got, want, s_abs, terms in ((xt.grad, xd.grad, s_dx, 9 * cout),
                                    (kt.grad, kd.grad, s_dw, n * h * w)):
        tol = BF16_UNIT * want.abs() + terms * 2.0 ** -23 * s_abs
        assert bool(((got.double() - want).abs() <= tol).all())
    np.testing.assert_allclose(bt.grad.numpy(),
                               g.double().sum((0, 1, 2)).numpy(), rtol=1e-6)


# ------------------------------------------------------------- trainable EDSR

def test_trainable_edsr_forward_values_and_clip_gradient_match_jax():
    """The training forward equals the inference forward; at outputs exactly
    0 and 1 the clip's gradient is jnp.clip's 0.5 (clamp's is 1)."""
    rng = np.random.default_rng(2)
    m, params = edsr_tree(rng, 2)
    params["tail"] = {"kernel": np.zeros_like(params["tail"]["kernel"]),
                      "bias": np.array([0.0, 1.0, 0.25], np.float32)}
    x = rng.random((2, 6, 6, 3), dtype=np.float32)
    dy = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda p: m.apply({"params": p}, jnp.asarray(x)),
                       jax.tree.map(jnp.asarray, params))
    g_tail = np.asarray(vjp(jnp.asarray(dy))[0]["tail"]["bias"])

    model = edsr_from_flax(params, 2, device="cpu")
    with torch.no_grad():
        y_inf = model(torch.from_numpy(x))
    assert not model.head.kernel.requires_grad
    model.trainable()
    assert all(p.requires_grad for p in model.parameters())
    y = model(torch.from_numpy(x))
    assert y.grad_fn is not None
    np.testing.assert_array_equal(y.detach().numpy(), y_inf.numpy())
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(model.tail.bias.grad.numpy(), g_tail,
                               rtol=GRAD_RTOL)
    s = dy.reshape(-1, 3).sum(0)
    np.testing.assert_allclose(g_tail[:2], 0.5 * s[:2], rtol=1e-5)
    assert model.trainable(False) is model and not model.tail.bias.requires_grad


def test_edsr_routes_each_conv_that_needs_a_gradient_through_the_function(
        monkeypatch):
    """Per conv: the K2 Function where grad mode is on and the conv's input,
    kernel or bias needs a gradient, plain K2 elsewhere. With the head
    frozen the other eight convs still train, and their gradients equal
    those of the fully trainable model."""
    from tpusr_torch.models import edsr as edsr_mod
    calls = []

    def counted(x, kernel, bias, relu=False):
        calls.append(tuple(kernel.shape))
        return conv3x3_bias_act_train(x, kernel, bias, relu)
    monkeypatch.setattr(edsr_mod, "conv3x3_bias_act_train", counted)
    rng = np.random.default_rng(4)
    _m, params = edsr_tree(rng, 4)
    x = torch.from_numpy(rng.random((2, 5, 5, 3), dtype=np.float32))
    full = edsr_from_flax(params, 4, device="cpu").trainable()
    full(x).square().sum().backward()
    assert len(calls) == 9
    calls.clear()
    model = edsr_from_flax(params, 4, device="cpu").trainable()
    model.head.requires_grad_(False)
    model(x).square().sum().backward()
    assert len(calls) == 8 and model.head.kernel.grad is None
    for name, p in model.named_parameters():
        if not name.startswith("head."):
            np.testing.assert_array_equal(
                p.grad.numpy(), dict(full.named_parameters())[name].grad.numpy())
    calls.clear()
    with torch.no_grad():
        model(x)
    model.trainable(False)(x)
    assert not calls


# -------------------------------------------------- trainers: shared set-up

def _narrow_vgg_cfg(monkeypatch):
    cfg = tuple((b, n, wd) for (b, n, _f), wd in zip(jvgg._VGG16_CFG,
                                                     NARROW_WIDTHS))
    monkeypatch.setattr(jvgg, "_VGG16_CFG", cfg)


def _setup(kind, monkeypatch, loss="mse", clipnorm=None, l2_reg=0.0,
           predicate=None, compute_dtype="float32"):
    """(jax trainer, jax params, port trainer, batches)"""
    dt = dict(compute_dtype=compute_dtype)
    rng = np.random.default_rng({"edsr": 0, "srcnn": 1, "vgg": 2}[kind])
    if kind == "edsr":
        jm, params = edsr_tree(rng, 4)
        port = edsr_from_flax(params, 4, device="cpu")
        jt = JaxSRTrainer(jm, LR, clipnorm=clipnorm, loss=loss, **dt)
        pt = SupervisedSRTrainer(port, LR, clipnorm=clipnorm, loss=loss,
                                 device="cpu", **dt)
        xs = rng.random((STEPS, 4, 8, 8, 3), dtype=np.float32)
        ys = rng.random((STEPS, 4, 32, 32, 3), dtype=np.float32)
    elif kind == "srcnn":
        jm = JaxSRCNN(f1=16, f2=8)
        params = to_numpy(jm.init(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 16, 16, 3)))["params"])
        params = jax.tree.map(lambda a: a + (0.02 * rng.standard_normal(
            a.shape)).astype(np.float32), params)
        port = srcnn_from_flax(params, device="cpu")
        jt = JaxSRTrainer(jm, LR, clipnorm=clipnorm, loss=loss, **dt)
        pt = SupervisedSRTrainer(port, LR, clipnorm=clipnorm, loss=loss,
                                 device="cpu", **dt)
        xs = rng.random((STEPS, 4, 16, 16, 3), dtype=np.float32)
        ys = np.clip(xs + 0.1 * rng.standard_normal(xs.shape), 0, 1).astype(np.float32)
    else:
        _narrow_vgg_cfg(monkeypatch)
        params = vgg16_tree(rng)
        jm = JaxVGG16(num_classes=2, dropout_rate=0.0, dense_units=16)
        port = vgg16_from_flax(params, device="cpu", dropout_rate=0.0)
        jt = JaxClassifierTrainer(jm, LR, l2_reg=l2_reg,
                                  trainable_predicate=predicate, **dt)
        pt = ClassifierTrainer(port, LR, l2_reg=l2_reg,
                               trainable_predicate=predicate, device="cpu",
                               **dt)
        xs = rng.random((STEPS, 4, 32, 32, 3), dtype=np.float32)
        ys = rng.integers(0, 2, (STEPS, 4)).astype(np.int32)
    return jt, params, pt, xs, ys


def _jax_state(jt, params, sample):
    st = jt.init_state(jnp.asarray(sample))
    return st.replace(params=jax.tree.map(jnp.asarray, params))


# ------------------------------------------------ first-step gradients

def _jax_sr_loss(model, x, y, w, loss):
    def f(p):
        pred = model.apply({"params": p}, x).astype(jnp.float32)
        d = pred - y
        per = jnp.mean(d ** 2 if loss == "mse" else jnp.abs(d), axis=(1, 2, 3))
        return jnp.sum(per * w) / jnp.sum(w)
    return f


def _jax_clf_loss(model, x, y, w, l2_reg):
    def f(p):
        probs = model.apply({"params": p}, x, True).astype(jnp.float32)
        logp = jnp.log(jnp.clip(probs, 1e-7, 1.0))
        ce = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return (jnp.sum(ce * w) / jnp.sum(w)
                + l2_reg * jnp.sum(p["fc1"]["kernel"] ** 2))
    return f


@pytest.mark.parametrize("kind,loss", [("edsr", "mse"), ("edsr", "mae"),
                                       ("srcnn", "mse"), ("vgg", None)])
def test_first_step_gradients_match_jax_grad(kind, loss, monkeypatch):
    jt, params, pt, xs, ys = _setup(kind, monkeypatch, loss=loss or "mse",
                                    l2_reg=1e-3 if kind == "vgg" else 0.0)
    x, y = xs[0], ys[0]
    w = np.array([1, 1, 1, 0], np.float32)     # a masked trailing row
    if kind == "vgg":
        f = _jax_clf_loss(jt.model, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(w), 1e-3)
    else:
        f = _jax_sr_loss(jt.model, jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(w), loss)
    loss_j, g_j = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, params))

    state = pt.init_state()
    loss_t, _, grads = pt.value_and_grad(
        state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        step=0)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    assert_grads_close(_flat(to_flax_tree(grads)), _flat(to_numpy(g_j)))


# ------------------------------------------------ 3 steps against JAX

CASES = {
    "edsr_mse": dict(kind="edsr"),
    "edsr_mae": dict(kind="edsr", loss="mae"),
    "edsr_clipnorm": dict(kind="edsr", clipnorm=0.05),
    "srcnn_mse": dict(kind="srcnn"),
    "srcnn_clipnorm": dict(kind="srcnn", clipnorm=1.0),
    "vgg_l2": dict(kind="vgg", l2_reg=1e-3),
    "vgg_frozen_convs": dict(kind="vgg",
                             predicate=lambda path: path[0] != "vgg16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case, monkeypatch):
    kw = CASES[case]
    jt, params, pt, xs, ys = _setup(monkeypatch=monkeypatch, **kw)
    st_j = _jax_state(jt, params, xs[0][:1])
    st_t = pt.init_state()
    before = {k: v.detach().clone() for k, v in st_t.params.items()}
    if kw.get("clipnorm"):       # the first step's global norm is clipped
        pt.clipnorm = None
        _, _, g = pt.value_and_grad(st_t, torch.from_numpy(xs[0]),
                                    torch.from_numpy(ys[0]))
        pt.clipnorm = kw["clipnorm"]
        assert sum(float((v * v).sum()) for v in g.values()) > kw["clipnorm"] ** 2
    clf = kw["kind"] == "vgg"
    keys = ("loss", "accuracy") if clf else ("loss", "psnr", "ssim")
    for step in range(STEPS):
        xj, yj = jnp.asarray(xs[step]), jnp.asarray(ys[step])
        xt, yt = torch.from_numpy(xs[step]), torch.from_numpy(ys[step])
        if clf:
            st_j, m_j = jt.train_step(st_j, xj, yj, step)
            st_t, m_t = pt.train_step(st_t, xt, yt, step)
        else:
            st_j, m_j = jt.train_step(st_j, xj, yj)
            st_t, m_t = pt.train_step(st_t, xt, yt)
        for k in keys:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{k} {step}")
    assert st_t.opt_state["count"] == STEPS
    assert_params_close(_flat(to_flax_tree(st_t.params)),
                        _flat(to_numpy(st_j.params)))
    if kw.get("predicate") is not None:       # frozen leaves never move
        frozen = [k for k in before if not kw["predicate"](flax_path(k))]
        assert frozen and all(torch.equal(st_t.params[k], before[k])
                              for k in frozen)
        assert set(st_t.opt_state["mu"]) == set(before) - set(frozen)
    ev_j = jt.eval_step(st_j, jnp.asarray(xs[0]), jnp.asarray(ys[0]))
    ev_t = pt.eval_step(st_t, torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
    for k in keys:
        np.testing.assert_allclose(float(ev_t[k]), float(ev_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_clip_by_global_norm_is_optax():
    import optax
    from tpusr_torch.train.trainer import clip_by_global_norm

    rng = np.random.default_rng(4)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    norm = float(np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in leaves)))
    for max_norm in (norm / 3, norm * 2):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in leaves], optax.EmptyState())
        got = clip_by_global_norm([torch.from_numpy(a) for a in leaves], max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # not clip_grad_norm_'s |g| + 1e-6
    small = [torch.full((4,), 1e-4)]
    got = clip_by_global_norm(small, 1e-4)[0]
    np.testing.assert_allclose(got.numpy(), np.full(4, 1e-4 / 2), rtol=1e-6)


# ------------------------------------------------ fit against JAX

def test_fit_history_matches_jax_with_masked_batch_plateau_and_early_stop():
    rng = np.random.default_rng(5)
    y = rng.random((14, 12, 12, 3), dtype=np.float32)
    x = np.clip(y + 0.2 * rng.standard_normal(y.shape), 0, 1).astype(np.float32)
    xv = rng.random((5, 12, 12, 3), dtype=np.float32)   # unrelated targets:
    yv = rng.random((5, 12, 12, 3), dtype=np.float32)   # val loss stalls
    jm = JaxSRCNN(f1=8, f2=4)
    params = to_numpy(jm.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 12, 12, 3)))["params"])
    kw = dict(batch_size=4, epochs=12, es_patience=2, plateau_patience=1,
              plateau_factor=0.5, seed=3, verbose=False)
    jt = JaxSRTrainer(jm, learning_rate=3e-2)
    res_j = jt.fit(x[:10], y[:10], xv, yv,
                   state=_jax_state(jt, params, x[:1]), **kw)
    pt = SupervisedSRTrainer(srcnn_from_flax(params, device="cpu"),
                             learning_rate=3e-2, device="cpu")
    res_t = pt.fit(x[:10], y[:10], xv, yv, **kw)
    h_j, h_t = res_j.history, res_t.history
    n = len(h_j["loss"])
    assert 2 < n < kw["epochs"], n                 # early stopping fired
    assert len(set(h_j["lr"])) > 1                 # the plateau fired
    assert set(h_t) == set(h_j)
    for k in ("loss", "psnr", "ssim", "val_loss", "val_psnr", "val_ssim"):
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=LOSS_RTOL, err_msg=k)
    assert h_t["lr"] == [float(v) for v in h_j["lr"]]
    assert len(res_t.time_tracker.epoch_times_sec) == n
    assert res_t.memory_tracker.as_dict()["gpu_peak_mb"] is None    # CPU
    # the best weights came back (10 = 3 batches of 4, the last masked)
    best = int(np.argmin(h_j["val_loss"]))
    assert best < n - 1
    assert_params_close(_flat(to_flax_tree(res_t.state.params)),
                        _flat(to_numpy(res_j.state.params)), steps=3 * n,
                        lr=3e-2)
    ev_t = pt.evaluate(res_t.state, xv, yv, batch_size=4)
    np.testing.assert_allclose(ev_t["loss"], h_t["val_loss"][best],
                               rtol=1e-6)


def test_classifier_fit_matches_jax(monkeypatch):
    _narrow_vgg_cfg(monkeypatch)
    rng = np.random.default_rng(6)
    params = vgg16_tree(rng)
    x = rng.random((10, 32, 32, 3), dtype=np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0.5).astype(np.int32)
    jt = JaxClassifierTrainer(JaxVGG16(num_classes=2, dropout_rate=0.0,
                                       dense_units=16), learning_rate=LR)
    pt = ClassifierTrainer(vgg16_from_flax(params, device="cpu",
                                           dropout_rate=0.0),
                           learning_rate=LR, device="cpu")
    kw = dict(batch_size=4, epochs=2, verbose=False, es_patience=5)
    res_j = jt.fit(x[:7], y[:7], x[7:], y[7:],
                   state=_jax_state(jt, params, x[:1]), **kw)
    res_t = pt.fit(x[:7], y[:7], x[7:], y[7:], **kw)
    for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(res_t.history[k], res_j.history[k],
                                   rtol=LOSS_RTOL, err_msg=k)


# ------------------------------------------------ remat and bf16

@pytest.mark.parametrize("kind", ["edsr", "srcnn"])
def test_remat_is_bit_for_bit_the_same_training(kind, monkeypatch):
    """``remat=True`` recomputes the forward in the backward (EDSR: each
    of its 9 convs once more through K2's Function, whose forward and dX
    calls are counted here) and trains bit for bit as without it."""
    _, _, pt, xs, ys = _setup(kind, monkeypatch)
    calls = {"n": 0}
    twin = conv3x3.conv3x3_bias_act

    def counted(*a, **kw):
        calls["n"] += 1
        return twin(*a, **kw)
    monkeypatch.setattr(conv3x3, "conv3x3_bias_act", counted)
    runs = {}
    for remat in (False, True):
        tr = SupervisedSRTrainer(pt.model, LR, remat=remat, device="cpu")
        st, ms, calls["n"] = tr.init_state(), [], 0
        for i in range(STEPS):
            st, m = tr.train_step(st, torch.from_numpy(xs[i]),
                                  torch.from_numpy(ys[i]))
            ms.append({k: float(v) for k, v in m.items()})
        ev = tr.eval_step(st, torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
        runs[remat] = (st, ms, {k: float(v) for k, v in ev.items()}, calls["n"])
    (a, ma, ea, na), (b, mb, eb, nb) = runs[False], runs[True]
    assert ma == mb and ea == eb
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert all(torch.equal(a.opt_state["nu"][k], b.opt_state["nu"][k])
               for k in a.params)
    n_conv = 9 if kind == "edsr" else 0       # SRCNN's convs are F.conv2d
    assert na == STEPS * max(2 * n_conv - 1, 0)
    assert nb == na + STEPS * n_conv


def test_classifier_trainer_has_no_remat_as_in_jax():
    vgg = VGG16Classifier(widths=(4, 4, 4, 4, 4), dense_units=4, device="cpu")
    with pytest.raises(TypeError, match="remat"):
        ClassifierTrainer(vgg, device="cpu", remat=True)
    with pytest.raises(TypeError, match="remat"):
        JaxClassifierTrainer(None, remat=True)


# bf16 roundings on the deepest path to the loss: EDSR x4 at 2 blocks has 9
# convs, SRCNN 3, VGG16 13 convs and 2 Dense layers
BF16_DEPTH = {"edsr": 9, "srcnn": 3, "vgg": 15}


@pytest.mark.parametrize("kind", ["edsr", "srcnn", "vgg"])
def test_bf16_step_matches_jax_bf16_step(kind, monkeypatch):
    """One bf16 step and an eval step of the port against JAX's, from the
    same weights and batch. Each bf16 rounding (unit 2^-8) moves a value
    by at most that share to first order, and the forward has
    ``BF16_DEPTH`` of them in a row, so the losses and metrics agree within
    ``BF16_DEPTH * 2^-8`` relative (SSIM, a difference of terms of size ~1,
    within that much absolutely). The port's bf16 loss differs from its
    float32 loss (so bf16 ran); parameters and moments stay float32."""
    jt, params, pt, xs, ys = _setup(kind, monkeypatch,
                                    compute_dtype="bfloat16")
    _, _, pt32, _, _ = _setup(kind, monkeypatch)
    clf = kind == "vgg"
    st_j = _jax_state(jt, params, xs[0][:1])
    xj, yj = jnp.asarray(xs[0]), jnp.asarray(ys[0])
    xt, yt = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
    args = (0,) if clf else ()
    st_j, m_j = jt.train_step(st_j, xj, yj, *args)
    st_t, m_t = pt.train_step(pt.init_state(), xt, yt, *args)
    _, m_f = pt32.train_step(pt32.init_state(), xt, yt, *args)
    tol = BF16_DEPTH[kind] * 2.0 ** -8

    def close(got, want):
        for k in keys:
            # SSIM is a difference of terms of size ~1: absolute there
            kw = dict(atol=tol, rtol=0) if k == "ssim" else dict(rtol=tol)
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=k, **kw)
    keys = ("loss", "accuracy") if clf else ("loss", "psnr", "ssim")
    close(m_t, m_j)
    assert float(m_t["loss"]) != float(m_f["loss"])
    close(pt.eval_step(st_t, xt, yt), jt.eval_step(st_j, xj, yj))
    assert all(v.dtype == torch.float32 for v in st_t.params.values())
    assert all(v.dtype == torch.float32
               for v in st_t.opt_state["mu"].values())


def test_compute_dtype_other_than_f32_and_bf16_raises():
    with pytest.raises(ValueError, match="bfloat16"):
        SupervisedSRTrainer(SRCNN(f1=4, f2=2, device="cpu"),
                            compute_dtype="float16", device="cpu")


# ------------------------------------------------ what is not in this slice

# the mesh is ported (tests/test_torch_dist_*.py): what is not a DeviceMesh
# is refused
@pytest.mark.parametrize("kw,item", [(dict(mesh=object()), "DeviceMesh")])
def test_options_of_later_slices_raise(kw, item):
    model = SRCNN(f1=4, f2=2, device="cpu")
    with pytest.raises(TypeError, match=item):
        SupervisedSRTrainer(model, device="cpu", **kw)
    vgg = VGG16Classifier(widths=(4, 4, 4, 4, 4), dense_units=4,
                          device="cpu")
    with pytest.raises(TypeError, match=item):
        ClassifierTrainer(vgg, device="cpu", **kw)


def test_unsupported_loss_raises():
    with pytest.raises(ValueError, match="Unsupported loss"):
        SupervisedSRTrainer(SRCNN(f1=4, f2=2, device="cpu"), loss="huber",
                            device="cpu")


def test_trainer_refuses_to_run_off_the_card_unasked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SupervisedSRTrainer(SRCNN(f1=4, f2=2, device="cpu"))


def test_init_state_draws_from_a_generator():
    model = EDSR(2, num_res_blocks=1, num_filters=4, device="cpu")
    tr = SupervisedSRTrainer(model, device="cpu")
    own = tr.init_state()
    a = tr.init_state(rng=torch.Generator().manual_seed(7))
    b = tr.init_state(rng=torch.Generator().manual_seed(7))
    for k, v in model.named_parameters():
        assert torch.equal(own.params[k], v) and own.params[k] is not v
        assert torch.equal(a.params[k], b.params[k])
    assert not torch.equal(a.params["head.kernel"], own.params["head.kernel"])
    assert own.lr == float(np.float32(1e-4)) and own.opt_state["count"] == 0
