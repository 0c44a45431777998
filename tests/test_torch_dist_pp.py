"""Pipeline parallelism in the port (tpusr_torch/dist/pp.py) on 4 gloo
ranks on the CPU: the pipelined EDSR forward and train step against the
port's dense model and the JAX package's (tests/test_pp.py), on the same
weights.

Tolerances: forwards atol 1e-5 rtol 1e-4 (JAX's own); losses rtol 1e-5;
gradients max|dg| <= 1e-6 * max|g| per leaf; parameters after the SGD step
atol 5e-6 rtol 5e-6 (JAX's own).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import to_numpy
from torch_dist_ranks import pp_suite, run_ranks
from tpusr.models import EDSR as JaxEDSR
from tpusr_torch.bridge import edsr_from_flax, flax_path
from tpusr_torch.dist import stack_res_params

FWD = dict(atol=1e-5, rtol=1e-4)
LR = 1e-2


def _tree(scale, blocks, filters=8):
    m = JaxEDSR(scale_factor=scale, num_res_blocks=blocks, num_filters=filters)
    return m, to_numpy(m.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8, 8, 3)))["params"])


def _inputs():
    rng = np.random.default_rng(0)
    trees = {"b8": _tree(2, 8)[1], "b4": _tree(2, 4)[1],
             "s3": _tree(3, 4)[1], "s4": _tree(4, 4)[1]}
    # name -> (tree, scale, mesh ("4": 4 stages; "22": 2 data x 2 stages),
    # n_micro, data_axis)
    fwd = {"micro4": ("b8", 2, "4", 4, None),
           "tail3": ("s3", 3, "22", 2, None),
           "tail4": ("s4", 4, "22", 2, None),
           "dp": ("b4", 2, "22", 4, "data")}
    x = {"micro4": rng.random((12, 8, 8, 3), dtype=np.float32),
         "tail3": rng.random((4, 6, 6, 3), dtype=np.float32),
         "tail4": rng.random((4, 6, 6, 3), dtype=np.float32),
         "dp": rng.random((8, 8, 8, 3), dtype=np.float32)}
    train = {"train": ("b8", "4", 4, LR, None),
             "train_dp": ("b4", "22", 2, LR, "data")}
    return {"trees": trees, "fwd": fwd, "x": x, "train": train,
            "tx": rng.random((8, 8, 8, 3), dtype=np.float32),
            "ty": rng.random((8, 16, 16, 3), dtype=np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pp = _inputs()
    return pp, run_ranks(pp_suite, 4, tmp_path_factory.mktemp("pp"), pp)


def test_stack_res_params_layout():
    _, tree = _tree(2, 8)
    params = dict(edsr_from_flax(tree, 2, device="cpu").named_parameters())
    stacked, rest = stack_res_params(params, 4)
    assert stacked["conv1"]["kernel"].shape[:2] == (4, 2)
    # stage 1, block 0 of the stage == res2
    np.testing.assert_array_equal(stacked["conv1"]["kernel"][1, 0].numpy(),
                                  tree["res2"]["conv1"]["kernel"])
    assert set(rest) == {"head", "body", "up0", "tail"}
    with pytest.raises(ValueError):
        stack_res_params(params, 3)


@pytest.mark.parametrize("name", ["micro4", "tail3", "tail4", "dp"])
def test_pp_forward_matches_dense(ranks, name):
    """4 stages of 2 blocks at n_micro 4; the x3 (one up0 at r=3) and x4
    (chained x2) tails over 2 stages; DP x PP on ('data', 'stage')."""
    pp, res = ranks
    tree, scale, *_ = pp["fwd"][name]
    x = pp["x"][name]
    model = edsr_from_flax(pp["trees"][tree], scale, device="cpu")
    with torch.no_grad():
        dense = model(torch.from_numpy(x)).numpy()
    blocks = sum(1 for k in pp["trees"][tree] if k.startswith("res"))
    want = np.asarray(JaxEDSR(scale_factor=scale, num_res_blocks=blocks,
                              num_filters=8).apply(
        {"params": pp["trees"][tree]}, jnp.asarray(x)))
    for r in res:
        np.testing.assert_allclose(r[name], dense, **FWD)
        np.testing.assert_allclose(r[name], want, **FWD)


def test_pp_validation_errors(ranks):
    _, res = ranks
    for r in res:
        assert "not divisible by n_micro" in r["error"]


def _dense_step(tree, x, y):
    model = edsr_from_flax(tree, 2, device="cpu").trainable()
    pred = model(torch.from_numpy(x))
    loss = torch.mean((pred - torch.from_numpy(y)) ** 2)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return float(loss.detach()), {k: g.numpy() for k, g in zip(names, grads)}


@pytest.mark.parametrize("name", ["train", "train_dp"])
def test_pp_train_step_matches_dense_grads(ranks, name):
    """Loss, every gradient leaf and the updated parameters of the PP step
    equal the dense step's (``train_dp``: DP x PP on (2, 2))."""
    pp, res = ranks
    tree = pp["trees"][pp["train"][name][0]]
    loss_1, g_1 = _dense_step(tree, pp["tx"], pp["ty"])
    # JAX's dense step on the same weights
    blocks = sum(1 for k in tree if k.startswith("res"))
    jm = JaxEDSR(scale_factor=2, num_res_blocks=blocks, num_filters=8)
    loss_j, g_j = jax.value_and_grad(lambda p: jnp.mean(
        (jm.apply({"params": p}, jnp.asarray(pp["tx"])) - pp["ty"]) ** 2))(
        jax.tree.map(jnp.asarray, tree))
    g_j = to_numpy(g_j)
    for r in res:
        loss, new, grads = r[name]
        np.testing.assert_allclose(loss, loss_1, rtol=1e-5)
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
        for k, g in g_1.items():
            scale = max(np.abs(g).max(), 1e-30)
            assert np.abs(grads[k] - g).max() <= 1e-6 * scale, k
            node = g_j
            for key in flax_path(k):
                node = node[key]
            assert np.abs(grads[k] - node).max() <= 1e-6 * scale, k
            p = tree
            for key in flax_path(k):
                p = p[key]
            np.testing.assert_allclose(new[k], p - LR * node, atol=5e-6,
                                       rtol=5e-6, err_msg=k)
