"""Tensor parallelism in the port (tpusr_torch/dist/tp.py) on 4 gloo ranks
on the CPU, a (2, 2) ('data', 'model') mesh: forwards and train steps with
output-channel-sharded parameters against the same calls unsharded and
against the JAX package's replicated run (tests/test_tp.py), on the same
weights.

Tolerances, JAX's own (tests/test_tp.py): forwards and parameters after a
step atol 2e-5 rtol 2e-5, losses 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tpusr.models.vgg as jvgg
from test_torch_fixtures import NARROW_WIDTHS, edsr_tree, to_numpy, vgg16_tree
from torch_dist_ranks import run_ranks, tp_suite
from tpusr.dist.tp import tp_spec as jax_tp_spec
from tpusr.models import EDSR as JaxEDSR
from tpusr.models import SRCNN as JaxSRCNN
from tpusr.models import VGG16Classifier as JaxVGG16
from tpusr_torch.dist import tp_spec

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs():
    rng = np.random.default_rng(0)
    _, edsr = edsr_tree(rng, 2, num_res_blocks=2, num_filters=64)
    _, edsr4 = edsr_tree(rng, 4, num_res_blocks=1, num_filters=8)
    srcnn = to_numpy(JaxSRCNN().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 12, 12, 3)))["params"])
    return {"vgg": vgg16_tree(rng),
            "vgg_x": rng.random((4, 32, 32, 3), dtype=np.float32),
            "edsr": edsr,
            "edsr_x": rng.random((2, 12, 12, 3), dtype=np.float32),
            "srcnn": srcnn,
            "srcnn_x": rng.random((8, 12, 12, 3), dtype=np.float32),
            "srcnn_y": rng.random((8, 12, 12, 3), dtype=np.float32),
            "edsr4": edsr4,
            "edsr4_x": rng.random((4, 6, 6, 3), dtype=np.float32),
            "edsr4_y": rng.random((4, 24, 24, 3), dtype=np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tp = _inputs()
    return tp, run_ranks(tp_suite, 4, tmp_path_factory.mktemp("tp"), tp)


def test_tp_spec_shards_output_channels_in_the_ports_layouts():
    """JAX's rule on the port's layouts: flax-layout ``kernel`` leaves shard
    their last dim, PyTorch-layout ``weight`` leaves and biases dim 0;
    indivisible leaves replicate."""
    import torch

    assert tp_spec("up0.kernel", torch.zeros(3, 3, 8, 32), 2) == (
        None, None, None, "model")
    assert tp_spec("conv1.weight", torch.zeros(96, 3, 9, 9), 2) == (
        "model", None, None, None)
    assert tp_spec("fc1.bias", torch.zeros(16), 2) == ("model",)
    assert tp_spec("tail.kernel", torch.zeros(3, 3, 8, 3), 2) == ()
    assert tuple(jax_tp_spec((), np.zeros((3, 3, 8, 32)), 2)) == (
        None, None, None, "model")
    assert tuple(jax_tp_spec((), np.zeros((3, 3, 8, 3)), 2)) == ()


def test_vgg16_forward_dp_tp_matches_replicated(ranks, monkeypatch):
    tp, res = ranks
    monkeypatch.setattr(jvgg, "_VGG16_CFG", tuple(
        (b, n, w) for (b, n, _f), w in zip(jvgg._VGG16_CFG, NARROW_WIDTHS)))
    want = np.asarray(JaxVGG16(num_classes=2, dense_units=16).apply(
        {"params": tp["vgg"]}, jnp.asarray(tp["vgg_x"])))
    for r in res:
        got, single = r["vgg"]
        np.testing.assert_allclose(got, single, **TOL)
        np.testing.assert_allclose(got, want, **TOL)
        # every conv, both dense layers (2 classes over 2 ranks) sharded,
        # and gathered back whole (what a checkpoint writes)
        assert len(r["vgg_sharded"]) == 2 * (13 + 2)
        assert r["vgg_gathered"]


def test_edsr_forward_tp_matches_replicated(ranks):
    tp, res = ranks
    want = np.asarray(JaxEDSR(scale_factor=2, num_res_blocks=2).apply(
        {"params": tp["edsr"]}, jnp.asarray(tp["edsr_x"])))
    for r in res:
        got, single = r["edsr"]
        np.testing.assert_allclose(got, single, **TOL)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["srcnn", "edsr4"])
def test_train_step_dp_tp_matches_replicated(ranks, name):
    """One step with the state sharded (parameters and Adam moments):
    ``srcnn`` as JAX's test, ``edsr4`` an EDSR x4 with clipnorm small
    enough to clip, so the norm sums the shards over 'model'. Each rank
    holds its shard: the test compares the shards with the same slices of
    the replicated step's parameters."""
    _, res = ranks
    for rank, r in enumerate(res):
        (loss_tp, p_tp), (loss_1, p_1) = r[name]
        np.testing.assert_allclose(loss_tp, loss_1, atol=1e-5, rtol=1e-5)
        model_rank = rank % 2
        for k, v in p_tp.items():
            want = p_1[k]
            if v.shape != want.shape:
                d = 0 if not k.endswith("kernel") else v.ndim - 1
                w = v.shape[d]
                want = np.take(want, range(model_rank * w, (model_rank + 1) * w),
                               axis=d)
            np.testing.assert_allclose(v, want, **TOL, err_msg=k)
