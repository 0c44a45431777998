"""The serving pipeline under a mesh in the port (tpusr_torch/pipeline,
``mesh=``) on 2 gloo ranks on the CPU: the cascade ranks the GLOBAL batch.

The cascade runs on tests/test_sharding.py's stub tables (its trunk,
quantizer and per-patch path replaced by lookups) with both scores, pad
rows (8 rows over 2 ranks, rows 0-3 and 4-7: ``n_valid`` 5 as JAX's test,
and 3, whose pad rows 3-7 cross the shard border) and the guard at 0.0 (it
trips), 0.6 and 1.01;
classes equal to the port's whole-batch run and to JAX's, confidences within
1e-4. Then the shipped serving mode on narrow networks, sharded and whole:
the same SR, classes and guard trips.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import tpusr.pipeline.cascade as jcasc
from test_torch_fixtures import edsr_tree, vgg16_tree
from torch_dist_ranks import cascade_suite, run_ranks
from tpusr.pipeline.cascade import make_cascade_votes

N = 8
CASES = ([(s, None, nv) for s in ("conf", "vote_frac") for nv in (None, 3, 5)]
         + [("vote_frac", g, nv) for g in (0.0, 0.6, 1.01)
            for nv in (None, 3, 5)])


def _tables():
    imgs = (np.arange(N * 2 * 2 * 3, dtype=np.float32).reshape(N, 2, 2, 3)
            / (N * 12.0))
    rng = np.random.default_rng(7)
    p1 = rng.uniform(0.05, 0.95, size=N)
    pp = rng.uniform(0.05, 0.95, size=N)
    return {"imgs": imgs, "img_means": imgs.mean(axis=(1, 2, 3)),
            "trunk": np.stack([1 - p1, p1], -1)[:, None, :].astype(np.float32),
            "pp": np.stack([1 - pp, pp], -1).astype(np.float32),
            "cases": CASES}


def _net():
    rng = np.random.default_rng(3)
    _, edsr = edsr_tree(rng, 2, num_res_blocks=1, num_filters=8)
    return {"edsr": edsr, "clf": vgg16_tree(rng),
            "calib": rng.random((4, 32, 32, 3)).astype(np.float32),
            "lr": rng.random((N, 16, 16, 3)).astype(np.float32),
            "n_valid": 5, "guard": 0.6}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tables = _tables()
    return tables, run_ranks(cascade_suite, 2,
                             tmp_path_factory.mktemp("cascade"), tables,
                             _net())


def _jax_votes(tables, monkeypatch):
    """JAX's cascade on the same tables (tests/test_sharding.py's stubs)."""
    img_means = jnp.asarray(tables["img_means"])
    pp_table = jnp.asarray(tables["pp"])

    def pp_apply(qtree, flat):
        means = flat.mean(axis=(1, 2, 3))
        idx = jnp.argmin(jnp.abs(means[:, None] - img_means[None, :]), axis=1)
        return pp_table[idx]

    monkeypatch.setattr(jcasc, "quantize_input", lambda q, x: x)
    monkeypatch.setattr(jcasc, "shared_trunk_probs_int8",
                        lambda q, x, p, s: jnp.asarray(tables["trunk"]))
    monkeypatch.setattr(jcasc, "quantized_vgg16_apply", pp_apply)
    out = {}
    for score, guard, n_valid in CASES:
        votes = make_cascade_votes({}, patch=2, stride=2, escalate_frac=0.25,
                                   escalate_score=score, guard_threshold=guard)
        args = (jnp.asarray(tables["imgs"]),) + (
            () if n_valid is None else (jnp.int32(n_valid),))
        cls, conf = votes(*args)
        out[(score, guard, n_valid)] = (np.asarray(cls), np.asarray(conf))
    return out


def test_cascade_sharded_batch_equality(ranks, monkeypatch):
    tables, res = ranks
    want = _jax_votes(tables, monkeypatch)
    for case in CASES:
        cls_j, conf_j = want[case]
        for r in res:
            (cls_dp, conf_dp, trips_dp, esc_dp), (cls_1, conf_1, trips_1,
                                                 esc_1) = r[case]
            np.testing.assert_array_equal(cls_dp, cls_1, err_msg=str(case))
            np.testing.assert_array_equal(cls_dp, cls_j, err_msg=str(case))
            np.testing.assert_allclose(conf_dp, conf_1, atol=1e-4)
            np.testing.assert_allclose(conf_dp, conf_j, atol=1e-4)
            assert trips_dp == trips_1
            # one global ranking: the same escalation set on every rank
            np.testing.assert_array_equal(esc_dp, esc_1)
    # the guard at 0.0 trips; at 1.01 it cannot
    assert res[0][("vote_frac", 0.0, 3)][0][2] == 1
    assert res[0][("vote_frac", 1.01, 3)][0][2] == 0


def test_pad_rows_across_a_shard_border_never_escalate(ranks):
    """K = 2 of 8; with ``n_valid`` 3 only rows 0-2 (rank 0) are real, so
    both escalations land there, whatever the pad rows on both ranks
    score."""
    _, res = ranks
    for score in ("conf", "vote_frac"):
        for n_valid in (3, 5):
            esc = res[0][(score, None, n_valid)][0][3]
            assert len(esc) == 2 and (esc < n_valid).all(), esc


def test_serving_pipeline_cascade_sharded_equals_whole_batch(ranks):
    _, res = ranks
    sr_1, cls_1, conf_1, trips_1 = res[0]["served"]["single"]
    for r in res:
        sr_dp, cls_dp, conf_dp, trips_dp = r["served"]["dp"]
        np.testing.assert_allclose(sr_dp, sr_1, atol=1e-6)
        np.testing.assert_array_equal(cls_dp, cls_1)
        np.testing.assert_allclose(conf_dp, conf_1, atol=1e-4)
        assert trips_dp == trips_1
