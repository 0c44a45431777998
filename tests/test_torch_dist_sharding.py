"""Data parallelism in the port (tpusr_torch/dist, the trainers' and the
fused pipeline's ``mesh``) on 2 gloo ranks on the CPU, against the same
calls without a mesh and against the JAX package's data-parallel steps on
its 8 virtual CPU devices (tests/test_sharding.py), on the same weights;
and the multi-process bootstrap (tests/test_bootstrap.py).

Tolerances: losses rtol 1e-5; PSNR and SSIM epoch means also atol 1e-7
(an SSIM near 0 is a sum of O(1) terms that cancel, in another order);
gradients max|dg| <= 1e-6 * max|g| per leaf; parameters after one Adam
step atol 1e-6 (as JAX's own DP test), except the GAN's, held as
tests/test_torch_train.py holds Adam steps: within 2 * lr everywhere (a
gradient that is ~0 in both runs, as the attention's key bias's, steps
either way by ~lr) and within 1e-3 * lr for 99.9% of the elements; classes
equal and confidences within 1e-4.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_fixtures import edsr_tree, to_numpy, vgg16_tree
from tpusr_torch.bridge import to_flax_tree
from torch_dist_ranks import dp_suite, run_ranks
from tpusr.dist import make_mesh as jax_make_mesh, shard_batch as jax_shard
from tpusr.models import SRCNN as JaxSRCNN
from tpusr.train import SupervisedSRTrainer as JaxSRTrainer
from tpusr.train.trainer import TrainState as JaxTrainState

WORLD = 2
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    y = rng.random((16, 12, 12, 3), dtype=np.float32)
    x = np.roll(y, 1, axis=1)
    srcnn = to_numpy(JaxSRCNN(f1=8, f2=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 12, 12, 3)))["params"])
    _, edsr = edsr_tree(rng, 4, num_res_blocks=2, num_filters=8)
    fy = rng.random((10, 12, 12, 3), dtype=np.float32)
    sr = {"x": x, "y": y, "srcnn": srcnn, "edsr": edsr,
          "x4": rng.random((8, 6, 6, 3), dtype=np.float32),
          "y4": rng.random((8, 24, 24, 3), dtype=np.float32),
          "fx": np.clip(fy + 0.2 * rng.standard_normal(fy.shape), 0, 1)
          .astype(np.float32), "fy": fy,
          "vx": rng.random((5, 12, 12, 3), dtype=np.float32),
          "vy": rng.random((5, 12, 12, 3), dtype=np.float32)}
    xc = rng.random((8, 32, 32, 3), dtype=np.float32)
    clf = {"params": vgg16_tree(rng), "x": xc,
           "y": (xc.mean(axis=(1, 2, 3)) > 0.5).astype(np.int64)}
    gan = {"seed": 1,
           "lr": rng.random((8, 8, 8, 3), dtype=np.float32) * 2 - 1,
           "hr": rng.random((8, 16, 16, 3), dtype=np.float32) * 2 - 1}
    _, edsr2 = edsr_tree(rng, 2, num_res_blocks=1, num_filters=8)
    pipe = {"edsr": edsr2, "clf": vgg16_tree(rng),
            "lr": rng.random((8, 16, 16, 3)).astype(np.float32)}
    return sr, clf, gan, pipe


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks(dp_suite, WORLD, tmp_path_factory.mktemp("dp"),
                             *inputs)


def _grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(got[k] - w).max() <= GRAD_RTOL * scale, k


def test_virtual_mesh_has_8_devices(ranks):
    """The port's mesh spans every rank of the group, axis 'data'."""
    _, res = ranks
    for r in res:
        assert r["mesh"] == (WORLD, ("data",))


def test_shard_batch_places_on_mesh(ranks):
    _, res = ranks
    for r in res:
        assert r["shard_rows"] == 16 // WORLD
        assert r["batch_sharding"] == ("data", None, None, None)


def test_data_parallel_step_matches_single_device(ranks):
    (sr, *_), res = ranks
    loss_1, params_1 = res[0]["srcnn"]["single"]
    for r in res:
        loss_dp, params_dp = r["srcnn"]["dp"]
        np.testing.assert_allclose(loss_dp, loss_1, rtol=LOSS_RTOL)
        for k in params_1:
            np.testing.assert_allclose(params_dp[k], params_1[k], atol=1e-6)
    # JAX's DP step on its 8 devices, from the same weights and batch
    jt = JaxSRTrainer(JaxSRCNN(f1=8, f2=4), learning_rate=1e-3,
                      mesh=jax_make_mesh())
    st = jt.init_state(sr["x"][:1])
    st = JaxTrainState(params=jax.tree.map(jnp.asarray, sr["srcnn"]),
                       opt_state=jt._opt_init(sr["srcnn"]), lr=st.lr)
    st, m = jt.train_step(st, *jax_shard(jt.mesh, sr["x"], sr["y"]))
    np.testing.assert_allclose(res[0]["srcnn"]["dp"][0], float(m["loss"]),
                               rtol=LOSS_RTOL)
    flat = {k: v for k, v in to_flax_tree_flat(res[0]["srcnn"]["dp"][1])}
    want = {k: v for k, v in _flat(to_numpy(st.params))}
    for k in want:
        np.testing.assert_allclose(flat[k], want[k], atol=2e-6)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def to_flax_tree_flat(params: dict):
    return _flat(to_flax_tree({k: torch.from_numpy(v)
                               for k, v in params.items()}))


def test_data_parallel_edsr_x4_loss_and_every_gradient_leaf(ranks):
    _, res = ranks
    loss_1, g_1 = res[0]["edsr"]["single"]
    for r in res:
        loss_dp, g_dp = r["edsr"]["dp"]
        np.testing.assert_allclose(loss_dp, loss_1, rtol=LOSS_RTOL)
        _grads_close(g_dp, g_1)


def test_fit_with_a_partial_trailing_batch_matches_single_device(ranks):
    """10 rows at batch 4: the last batch holds 2 real rows and 2 masked
    pads, split 2 + 2 over the ranks; the epoch means stay global."""
    _, res = ranks
    h_1, p_1 = res[0]["fit"]["single"]
    for r in res:
        h_dp, p_dp = r["fit"]["dp"]
        assert set(h_dp) == set(h_1)
        for k in ("loss", "psnr", "ssim", "val_loss", "val_psnr", "val_ssim"):
            np.testing.assert_allclose(h_dp[k], h_1[k], rtol=LOSS_RTOL,
                                       atol=0 if "loss" in k else 1e-7,
                                       err_msg=k)
        assert h_dp["lr"] == h_1["lr"]
        for k in p_1:
            np.testing.assert_allclose(p_dp[k], p_1[k], atol=1e-5)


def test_data_parallel_classifier_step_with_dropout_matches_single_device(
        ranks):
    """Each rank keeps its rows of the global batch's dropout masks, and
    the L2 penalty counts once."""
    _, res = ranks
    loss_1, acc_1, p_1 = res[0]["clf"]["single"]
    for r in res:
        loss_dp, acc_dp, p_dp = r["clf"]["dp"]
        np.testing.assert_allclose(loss_dp, loss_1, rtol=LOSS_RTOL)
        assert acc_dp == acc_1
        for k in p_1:
            np.testing.assert_allclose(p_dp[k], p_1[k], atol=1e-6, err_msg=k)


def test_gan_step_data_parallel(ranks):
    _, res = ranks
    m_1, v_1, g_1, u_1 = res[0]["gan"]["single"]
    for r in res:
        m_dp, v_dp, g_dp, u_dp = r["gan"]["dp"]
        assert all(np.isfinite(v) for v in m_dp.values())
        for k in m_1:
            np.testing.assert_allclose(m_dp[k], m_1[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        # 3 validation rows do not split over 2 ranks: replicated
        for k in v_1:
            np.testing.assert_allclose(v_dp[k], v_1[k], rtol=LOSS_RTOL)
        g_lr = 1e-4
        diff = np.concatenate([np.abs(g_dp[k] - g_1[k]).ravel() for k in g_1])
        assert diff.max() <= 2 * g_lr
        assert np.mean(diff <= 1e-3 * g_lr) >= 0.999
        for k in u_1:   # the spectral-norm u: equal on every rank
            np.testing.assert_array_equal(u_dp[k], res[0]["gan"]["dp"][3][k])
            np.testing.assert_allclose(u_dp[k], u_1[k], atol=1e-6)


def test_fused_pipeline_sharded_batch(ranks):
    _, res = ranks
    sr_1, cls_1, conf_1 = res[0]["fused"]["single"]
    for r in res:
        sr_dp, cls_dp, conf_dp = r["fused"]["dp"]
        assert sr_dp.shape == sr_1.shape
        np.testing.assert_allclose(sr_dp, sr_1, atol=1e-6)
        np.testing.assert_array_equal(cls_dp, cls_1)
        np.testing.assert_allclose(conf_dp, conf_1, atol=1e-4)
