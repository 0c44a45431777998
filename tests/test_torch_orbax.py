"""The port's Orbax checkpoints (``tpusr_torch/train/{orbax,checkpoint}.py``,
the states through ``bridge``) against the JAX package's, on the CPU.

- each JAX state of ``tests/data/orbax/make_fixture.py`` (SRCNN, EDSR x2,
  VGG16 with a frozen base, the ESRGAN ``GANState`` with the JAX
  discriminator), two JAX steps in so the moments are not zero (the GAN's
  two steps its optimisers' alone), saved by JAX's ``save_checkpoint``:
  the port restores every leaf equal, and JAX's ``restore_checkpoint`` reads the
  port's save of that state back equal (a full-width EDSR x4
  ``TrainState``: ``tests/test_torch_orbax_full.py``);
- the committed fixtures restore into the port, whose networks give JAX's
  stored outputs;
- a frozen parameter's moment that is not zero is kept, as JAX keeps it;
  a GAN's two counts that differ raise naming the leaf;
- the facades and ``--resume`` take JAX's checkpoints; the port's
  ``torch.save`` files of earlier versions are still read.
"""

import importlib.util
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tpusr.train.checkpoint import restore_checkpoint as jax_restore
from tpusr.train.checkpoint import save_checkpoint as jax_save
from tpusr_torch import bridge
from tpusr_torch.models import EDSR, SRCNN, VGG16Classifier
from tpusr_torch.models.esrgan import ESRGANDiscriminator, ESRGANGenerator
from tpusr_torch.models.vgg import VGG19Features
from tpusr_torch.train import (ClassifierTrainer, ESRGANTrainer,
                               SupervisedSRTrainer, load_metadata,
                               restore_checkpoint, save_checkpoint)
from tpusr_torch.train import orbax

FIXTURES = pathlib.Path(__file__).parent / "data" / "orbax"
NAMES = ("srcnn", "edsr_x2", "vgg16", "esrgan_x2")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)   # one forward, f32, CPU


def _load_make_fixture():
    spec = importlib.util.spec_from_file_location(
        "orbax_make_fixture", FIXTURES / "make_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # flax's dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


mf = _load_make_fixture()


def port_state(name: str, arch: dict):
    """(port trainer, its initial state, forward(state, x)) for a fixture's
    architecture."""
    dev = "cpu"
    if name == "srcnn":
        m = SRCNN(f1=arch["f1"], f2=arch["f2"], device=dev)
        tr = SupervisedSRTrainer(m, 1e-3, device=dev)
    elif name.startswith("edsr"):
        m = EDSR(scale_factor=arch["scale_factor"], channels=arch["channels"],
                 num_res_blocks=arch["num_res_blocks"],
                 num_filters=arch["num_filters"],
                 res_scaling=arch["res_scaling"], device=dev)
        tr = SupervisedSRTrainer(m, 1e-3, clipnorm=1.0, device=dev)
    elif name == "vgg16":
        m = VGG16Classifier(num_classes=arch["num_classes"],
                            dense_units=arch["dense_units"],
                            widths=tuple(arch["widths"]),
                            dropout_rate=arch["dropout_rate"], device=dev)
        tr = ClassifierTrainer(m, 1e-3, device=dev,
                               trainable_predicate=lambda p: p[0] != "vgg16")
    else:
        m = ESRGANGenerator(scale_factor=arch["scale_factor"],
                            growth_channels=arch["growth_channels"],
                            num_rrdb_blocks=arch["num_rrdb_blocks"],
                            base_filters=arch["base_filters"], device=dev)
        d = ESRGANDiscriminator(device=dev)
        tr = ESRGANTrainer(m, d, VGG19Features(
            widths=tuple(arch["vgg19_widths"]), device=dev), device=dev)
        return tr, tr.init_state(), lambda s, x: functional_call(
            m, s.g_params, (x,))
    return tr, tr.init_state(), lambda s, x: functional_call(
        m, s.params, (x,))


def jax_leaves(state) -> dict:
    """A JAX state's leaves by key path (attribute, dict key or index)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        keys = tuple(str(getattr(p, "name", getattr(p, "key",
                                                    getattr(p, "idx", p))))
                     for p in path)
        out[keys] = np.asarray(leaf)
    return out


def port_leaves(state) -> dict:
    """A port state in the JAX state's tree and layouts, by key path."""
    tree = (bridge.gan_state_to_jax(state) if bridge.is_gan_state(state)
            else bridge.train_state_to_jax(state))
    return dict((tuple(k for k, _t in keys), np.asarray(v))
                for keys, v in orbax._flatten(tree))


def assert_same_leaves(got: dict, want: dict):
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        assert np.array_equal(g, w), k


def _moments_not_zero(leaves: dict):
    mu = [v for k, v in leaves.items() if "mu" in k and v.size > 1]
    assert mu and any(np.any(v != 0) for v in mu)


@pytest.fixture(scope="module")
def jax_states():
    """The four states; the GAN's two steps are its optimisers' alone
    (``make_fixture.esrgan_state``), the committed fixture's whole ones."""
    return {name: (mf.esrgan_state(train=False) if name == "esrgan_x2"
                   else mf.STATES[name]()) for name in NAMES}


@pytest.fixture(scope="module")
def restored(jax_states, tmp_path_factory):
    """name -> (the port's template, its restore of the JAX state that
    JAX's ``save_checkpoint`` wrote), each restored once."""
    cache = {}

    def get(name):
        if name not in cache:
            d = tmp_path_factory.mktemp(name)
            jax_save(str(d), name, jax_states[name][1])
            _pt, template, _f = port_state(name, mf.ARCH[name])
            cache[name] = template, restore_checkpoint(str(d), name, template)
        return cache[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_jax_state_restores_into_the_port_leaf_for_leaf(name, jax_states,
                                                        restored):
    template, got = restored(name)
    want = jax_leaves(jax_states[name][1])
    _moments_not_zero(want)
    assert_same_leaves(port_leaves(got), want)
    for tree in ("params", "g_params", "d_params"):
        for k, v in getattr(got, tree, {}).items():
            assert v.requires_grad == getattr(template, tree)[k].requires_grad
            assert v.is_contiguous(), k
    if name == "vgg16":      # the frozen convolutions keep no moments
        assert set(got.opt_state["mu"]) == {k for k in got.params
                                            if not k.startswith("vgg16.")}


@pytest.mark.parametrize("name", NAMES)
def test_port_save_restores_in_jax_leaf_for_leaf(name, jax_states, restored,
                                                 tmp_path):
    st_j = jax_states[name][1]
    _template, st_t = restored(name)
    path = save_checkpoint(str(tmp_path / "t"), name, st_t,
                           metadata={"arch": mf.ARCH[name]})
    assert os.path.isdir(path) and orbax.is_checkpoint(path)
    assert load_metadata(str(tmp_path / "t"), name) == {"arch": mf.ARCH[name]}
    blank = jax.tree.map(jnp.zeros_like, st_j)
    back = jax_restore(str(tmp_path / "t"), name, blank)
    assert_same_leaves(jax_leaves(back), jax_leaves(st_j))


@pytest.mark.parametrize("name", NAMES)
def test_committed_fixture_gives_jax_outputs(name, jax_states):
    """The port's restore of a committed fixture holds JAX's restore of it,
    and its network gives JAX's stored output."""
    meta = json.load(open(FIXTURES / f"{name}.meta.json"))
    _pt, template, fwd = port_state(name, meta["arch"])
    st = restore_checkpoint(str(FIXTURES), name, template)
    blank = jax.tree.map(jnp.zeros_like, jax_states[name][1])
    assert_same_leaves(port_leaves(st), jax_leaves(
        jax_restore(str(FIXTURES), name, blank)))
    io = np.load(FIXTURES / "outputs.npz")
    with torch.no_grad():
        y = fwd(st, torch.from_numpy(io[f"{name}_x"]))
    np.testing.assert_allclose(y.numpy(), io[f"{name}_y"], **FWD_TOL)


def test_a_frozen_moment_that_is_not_zero_raises_naming_it(jax_states,
                                                           tmp_path):
    """A frozen parameter's moment that is not zero no longer raises: the
    port keeps it, as the JAX trainer does, under its name
    (``tests/test_torch_orbax_frozen.py`` steps and saves such states)."""
    _tr, st_j, _fwd, _x = jax_states["vgg16"]
    mu = jax.tree.map(np.asarray, st_j.opt_state.mu)
    mu["vgg16"]["block2_conv1"]["kernel"] = np.ones_like(
        mu["vgg16"]["block2_conv1"]["kernel"])
    st_j = st_j.replace(opt_state=st_j.opt_state._replace(mu=mu))
    jax_save(str(tmp_path), "v", st_j)
    _pt, template, _f = port_state("vgg16", mf.ARCH["vgg16"])
    got = restore_checkpoint(str(tmp_path), "v", template)
    kept = got.opt_state["mu"]["vgg16.block2_conv1.weight"]
    assert bool((kept == 1).all())
    assert "vgg16.block2_conv1.weight" not in got.opt_state["nu"]
    assert_same_leaves(port_leaves(got), jax_leaves(st_j))


def test_gan_counts_that_differ_raise(jax_states, tmp_path):
    st_j = jax_restore(str(FIXTURES), "esrgan_x2", jax.tree.map(
        jnp.zeros_like, jax_states["esrgan_x2"][1]))
    g_opt = (st_j.g_opt[0], st_j.g_opt[1]._replace(count=jnp.asarray(
        7, jnp.int32)))
    jax_save(str(tmp_path), "g", st_j.replace(g_opt=g_opt))
    _pt, template, _f = port_state("esrgan_x2", mf.ARCH["esrgan_x2"])
    with pytest.raises(ValueError, match="g_opt: Adam's count 2"):
        restore_checkpoint(str(tmp_path), "g", template)


def test_a_mismatched_architecture_raises_naming_the_leaf(tmp_path):
    _pt, template, _f = port_state("edsr_x2", {**mf.ARCH["edsr_x2"],
                                               "num_filters": 8})
    with pytest.raises(ValueError, match="params/head.kernel"):
        restore_checkpoint(str(FIXTURES), "edsr_x2", template)


def test_resume_from_a_jax_epoch_point_takes_jax_next_step(jax_states,
                                                           tmp_path):
    """JAX's ``fit`` writes ``epoch_0001``; the port resumes from it as the
    CLI's ``--resume`` does, and its next step's loss is JAX's."""
    from tpusr_torch.cli.__main__ import _ckpt_kwargs, _maybe_resume
    jt, st_j, _fwd, _x = jax_states["edsr_x2"]
    rng = np.random.default_rng(9)
    x = rng.random((6, 8, 8, 3), dtype=np.float32)
    y = rng.random((6, 16, 16, 3), dtype=np.float32)
    jt.fit(x[:4], y[:4], x[4:], y[4:], batch_size=2, epochs=1,
           state=jax.tree.map(jnp.copy, st_j),     # fit donates its state
           checkpoint_dir=str(tmp_path), checkpoint_every=1, verbose=False)
    ck = str(tmp_path / "epoch_0001")
    pt, _template, _f = port_state("edsr_x2", mf.ARCH["edsr_x2"])
    args = type("A", (), {"resume": ck, "checkpoint_every": 1,
                          "out": str(tmp_path / "port")})()
    st_t = _maybe_resume(args, pt, ())
    assert _ckpt_kwargs(args)["checkpoint_offset"] == 1
    st_r = jax_restore(str(tmp_path), "epoch_0001",
                       jax.tree.map(jnp.zeros_like, st_j))
    assert st_t.opt_state["count"] == int(st_r.opt_state.count) == 4
    st_r, m_j = jt.train_step(st_r, jnp.asarray(x[:2]), jnp.asarray(y[:2]))
    st_t, m_t = pt.train_step(st_t, torch.from_numpy(x[:2]),
                              torch.from_numpy(y[:2]))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-4)


def test_facades_take_each_others_checkpoints(jax_states, tmp_path):
    """A JAX facade's save is the port facade's ``from_pretrained`` and the
    port's save the JAX facade's, under the JAX facades' names."""
    import tpusr.models.api as japi
    import tpusr_torch.models.api as tapi

    je = japi.EDSR()                      # the trained state, as fit leaves it
    je.scale_factor, je._arch = 2, dict(mf.ARCH["edsr_x2"])
    je.state, je.trained = jax_states["edsr_x2"][1], True
    jpath = je.save(str(tmp_path / "j"), "t")
    te = tapi.EDSR(device="cpu")
    te.setup_model(from_pretrained=True, pretrained_path=jpath)
    assert te.scale_factor == 2 and te.trained
    assert_same_leaves(port_leaves(te.state), jax_leaves(je.state))
    tpath = te.save(str(tmp_path / "t"), "t")
    assert os.path.basename(tpath) == os.path.basename(jpath) == "EDSR_x2_t"
    back = japi.EDSR()
    back.setup_model(from_pretrained=True, pretrained_path=tpath)
    assert_same_leaves(jax_leaves(back.state), jax_leaves(je.state))


def test_an_earlier_torch_save_checkpoint_is_still_read(tmp_path):
    _pt, template, _f = port_state("srcnn", mf.ARCH["srcnn"])
    from tpusr_torch.train.checkpoint import _flatten
    leaves = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
              for k, v in _flatten(template).items()}
    torch.save(leaves, tmp_path / "old")
    got = restore_checkpoint(str(tmp_path), "old", template)
    assert all(torch.equal(got.params[k], v)
               for k, v in template.params.items())
