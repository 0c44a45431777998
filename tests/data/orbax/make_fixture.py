"""Rewrite the JAX-written Orbax checkpoints of ``tests/data/orbax``.

Four narrow states, each after two JAX training steps on seeded data (so
Adam's moments are not zero), saved by the JAX package's
``save_checkpoint`` with an ``arch`` sidecar that says how to rebuild the
network:

- ``srcnn``: an SRCNN ``TrainState`` (f1 4, f2 2);
- ``edsr_x2``: an EDSR x2 ``TrainState`` (1 block of 4 filters, clipnorm 1);
- ``vgg16``: a VGG16 classifier ``TrainState`` at widths 2-4 with its
  convolutions frozen (their moments stay zero, as the JAX trainer keeps
  them);
- ``esrgan_x2``: an ESRGAN ``GANState`` (growth 2, 1 RRDB, 8 base filters)
  with ``tpusr.models.ESRGANDiscriminator``, whose widths are fixed: its
  658,305 weights and their moments are saved as zeros (RLE blocks), so
  that the directory stays small; the generator's are as trained.

``outputs.npz`` holds each network's seeded input (``<name>_x``) and JAX's
output on it (``<name>_y``). The port's tests and the chip smoke restore
these and compare. Run from the repository's root:

    JAX_PLATFORMS=cpu python tests/data/orbax/make_fixture.py
"""

from __future__ import annotations

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

import tpusr.models.vgg as jvgg  # noqa: E402
from tpusr.models import (EDSR, SRCNN, ESRGANDiscriminator,  # noqa: E402
                          ESRGANGenerator)
from tpusr.train import ClassifierTrainer, SupervisedSRTrainer  # noqa: E402
from tpusr.train.gan import ESRGANTrainer  # noqa: E402

STEPS = 2
ARCH = {
    "srcnn": {"f1": 4, "f2": 2},
    "edsr_x2": {"scale_factor": 2, "channels": 3, "num_res_blocks": 1,
                "num_filters": 4, "res_scaling": 0.1},
    "vgg16": {"input_shape": [32, 32, 3], "num_classes": 2,
              "dropout_rate": 0.0, "widths": [2, 2, 4, 4, 4],
              "dense_units": 8, "frozen_base": True},
    "esrgan_x2": {"scale_factor": 2, "growth_channels": 2,
                  "num_rrdb_blocks": 1, "base_filters": 8,
                  "vgg19_widths": [2, 2, 4, 4, 4]},
}


@contextlib.contextmanager
def narrow_vgg(name: str, widths):
    """``tpusr.models.vgg``'s block config ``name`` at ``widths`` while the
    block runs (its networks read the config when they are called)."""
    old = getattr(jvgg, name)
    setattr(jvgg, name, tuple((b, n, w) for (b, n, _f), w in zip(old, widths)))
    try:
        yield
    finally:
        setattr(jvgg, name, old)


def _init(tr, sample, seed):
    """The trainer's ``init_state`` from ``PRNGKey(seed)``, compiled once
    (op by op it compiles every layer's shapes)."""
    return jax.jit(tr.init_state)(jnp.asarray(sample),
                                  jax.random.PRNGKey(seed))


def _rng(name):
    return np.random.default_rng(sorted(ARCH).index(name))


def srcnn_state(steps=STEPS):
    """(JAX trainer, state after ``steps``, forward fn, sample input)."""
    a = ARCH["srcnn"]
    m = SRCNN(f1=a["f1"], f2=a["f2"])
    tr = SupervisedSRTrainer(m, 1e-3)
    rng = _rng("srcnn")
    x = rng.random((steps + 1, 1, 16, 16, 3), dtype=np.float32)
    st = _init(tr, x[0], 1)
    for i in range(steps):
        st, _ = tr.train_step(st, jnp.asarray(x[i]), jnp.asarray(
            np.clip(x[i] + 0.1, 0, 1)))
    return tr, st, lambda s, xx: m.apply({"params": s.params}, xx), x[-1]


def edsr_state(steps=STEPS, train=True, **arch):
    """``train=False`` draws the weights and takes ``steps`` of the
    trainer's Adam on seeded gradients in place of whole steps (at full
    width those compile for seconds on the CPU): the same tree, the
    moments and count not zero."""
    a = {**ARCH["edsr_x2"], **arch}
    m = EDSR(scale_factor=a["scale_factor"], channels=a["channels"],
             num_res_blocks=a["num_res_blocks"], num_filters=a["num_filters"],
             res_scaling=a["res_scaling"])
    tr = SupervisedSRTrainer(m, 1e-3, clipnorm=1.0)
    rng = _rng("edsr_x2")
    s = a["scale_factor"]
    x = rng.random((steps + 1, 1, 8, 8, 3), dtype=np.float32)
    y = rng.random((steps, 1, 8 * s, 8 * s, 3), dtype=np.float32)
    if train:
        st = _init(tr, x[0], 2)
        for i in range(steps):
            st, _ = tr.train_step(st, jnp.asarray(x[i]), jnp.asarray(y[i]))
    else:
        shapes = jax.eval_shape(tr.init_state, x[0], jax.random.PRNGKey(2))
        params = _drawn(shapes.params, rng)
        st = shapes.replace(params=params, opt_state=tr._opt_init(params),
                            lr=jnp.asarray(tr.base_lr, jnp.float32))
        step = _adam_train_step()
        for _ in range(steps):
            st = step(st, _drawn(shapes.params, rng, 1.0))
    return tr, st, lambda s_, xx: m.apply({"params": s_.params}, xx), x[-1]


def vgg16_state(steps=STEPS):
    a = ARCH["vgg16"]
    with narrow_vgg("_VGG16_CFG", a["widths"]):
        m = jvgg.VGG16Classifier(num_classes=a["num_classes"],
                                 dropout_rate=a["dropout_rate"],
                                 dense_units=a["dense_units"])
        tr = ClassifierTrainer(m, 1e-3,
                               trainable_predicate=lambda p: p[0] != "vgg16")
        rng = _rng("vgg16")
        x = rng.random((steps + 1, 2, 32, 32, 3), dtype=np.float32)
        y = np.array([[0, 1]] * steps, np.int32)
        st = _init(tr, x[0], 3)
        for i in range(steps):
            st, _ = tr.train_step(st, jnp.asarray(x[i]), jnp.asarray(y[i]), i)

    def fwd(s, xx):
        with narrow_vgg("_VGG16_CFG", a["widths"]):
            return m.apply({"params": s.params}, xx)
    return tr, st, fwd, x[-1][:1]


def esrgan_state(steps=STEPS, train=True):
    """``train=False`` draws the weights and ``u`` and takes ``steps`` of
    the trainers' Adams on seeded gradients in place of whole GAN steps,
    which compile for a minute on the CPU: the same tree, the moments and
    counts not zero."""
    a = ARCH["esrgan_x2"]
    g = ESRGANGenerator(scale_factor=a["scale_factor"],
                        growth_channels=a["growth_channels"],
                        num_rrdb_blocks=a["num_rrdb_blocks"],
                        base_filters=a["base_filters"])
    d = ESRGANDiscriminator()
    rng = _rng("esrgan_x2")
    with narrow_vgg("_VGG19_CFG", a["vgg19_widths"]):
        v = jvgg.VGG19Features()
        vp = (jax.jit(v.init)(jax.random.PRNGKey(4), jnp.zeros(
            (1, 16, 16, 3)))["params"] if train else None)
        tr = ESRGANTrainer(g, d, v, vp)
        init = lambda k: tr.init_state((8, 8, 3), (16, 16, 3), k)  # noqa: E731
        lr = rng.random((steps + 1, 1, 8, 8, 3), dtype=np.float32) * 2 - 1
        hr = rng.random((steps, 1, 16, 16, 3), dtype=np.float32) * 2 - 1
        if train:
            st = jax.jit(init)(jax.random.PRNGKey(5))
            for i in range(steps):
                st, _ = tr.train_step(st, jnp.asarray(lr[i]),
                                      jnp.asarray(hr[i]))
        else:
            shapes = jax.eval_shape(init, jax.random.PRNGKey(5))
            gp, dp = (_drawn(shapes.g_params, rng),
                      _drawn(shapes.d_params, rng))
            st = shapes.replace(g_params=gp, d_params=dp,
                                d_spectral=_drawn(shapes.d_spectral, rng),
                                g_opt=tr.g_tx.init(gp), d_opt=tr.d_tx.init(dp),
                                step=jnp.zeros((), jnp.int32))
            step = _adam_steps(tr)
            for _ in range(steps):
                st = step(st, _drawn(shapes.g_params, rng, 1.0),
                          _drawn(shapes.d_params, rng, 1.0))
    return tr, st, lambda s, xx: g.apply({"params": s.g_params}, xx), lr[-1]


def _drawn(shapes, rng, scale=0.05):
    """A tree of float32 arrays of ``shapes`` (``jax.eval_shape``'s),
    normal draws from ``rng`` times ``scale``."""
    return jax.tree.map(lambda sd: jnp.asarray(
        rng.standard_normal(sd.shape).astype(np.float32) * scale), shapes)


def _adam_train_step():
    """One step of ``SupervisedSRTrainer``'s Adam (``scale_by_adam``, then
    the state's ``lr``) on given gradients."""
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)

    @jax.jit
    def step(st, grads):
        u, opt = adam.update(grads, st.opt_state, st.params)
        return st.replace(params=jax.tree.map(
            lambda p, v: p - st.lr * v, st.params, u), opt_state=opt)
    return step


def _adam_steps(tr):
    """One step of the GAN trainer's two Adams on given gradients."""
    @jax.jit
    def step(st, g_grads, d_grads):
        upd = {}
        for p, tx, grads in (("g", tr.g_tx, g_grads), ("d", tr.d_tx, d_grads)):
            params, opt = getattr(st, f"{p}_params"), getattr(st, f"{p}_opt")
            u, opt = tx.update(grads, opt, params)
            upd[f"{p}_params"] = jax.tree.map(jnp.add, params, u)
            upd[f"{p}_opt"] = opt
        return st.replace(step=st.step + 1, **upd)
    return step


STATES = {"srcnn": srcnn_state, "edsr_x2": edsr_state, "vgg16": vgg16_state,
          "esrgan_x2": esrgan_state}


def without_discriminator_weights(st):
    """A ``GANState`` whose discriminator weights and Adam moments are
    zeros (its spectral ``u``, counts and step as they were)."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    adam, sched = st.d_opt
    return st.replace(d_params=zeros(st.d_params), d_opt=(adam._replace(
        mu=zeros(adam.mu), nu=zeros(adam.nu)), sched))


def main():
    from tpusr.train.checkpoint import save_checkpoint

    outs = {}
    for name, make in STATES.items():
        _tr, st, fwd, x = make()
        if name == "esrgan_x2":
            st = without_discriminator_weights(st)
        save_checkpoint(HERE, name, st, metadata={"arch": ARCH[name]})
        outs[f"{name}_x"] = x
        outs[f"{name}_y"] = np.asarray(fwd(st, jnp.asarray(x)), np.float32)
    np.savez_compressed(os.path.join(HERE, "outputs.npz"), **outs)


if __name__ == "__main__":
    main()
