"""Spatial sharding in the port (tpusr_torch/dist/spatial.py) on 2 gloo
ranks on the CPU: ring attention and full-image ESRGAN SR with the image's
rows split (halo exchanges before every 3x3 conv, the ring at both
attention sites) against the port's dense layer and generator and the JAX
package's (tests/test_spatial.py), on the same weights.

Tolerances: ring against dense 1e-5; the SR 5e-5 (JAX's own, and
``__graft_entry__.dryrun_multichip``'s).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from test_torch_fixtures import to_numpy
from torch_dist_ranks import run_ranks, sp_suite
from tpusr.models import ESRGANGenerator as JaxGenerator
from tpusr.models.layers import SelfAttention as JaxSelfAttention

GEN = dict(scale_factor=2, growth_channels=4, num_rrdb_blocks=1,
           base_filters=8)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.random((2, 8, 8, 16), dtype=np.float32)
    attn = to_numpy(JaxSelfAttention(channels=16).init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    gen = to_numpy(JaxGenerator(**GEN).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    # the port's 1x1 projections are (Cin, Cout) matrices
    port_attn = {f"{k}.{leaf}": (v[leaf][0, 0] if leaf == "kernel" else v[leaf])
                 for k, v in attn.items() for leaf in v}
    return {"attn_x": x, "attn_flax": attn, "attn": port_attn, "gen": gen,
            "img": rng.random((1, 16, 16, 3), dtype=np.float32) * 2 - 1,
            "lr16": rng.random((16, 16, 3), dtype=np.float32),
            "lr17": rng.random((17, 16, 3), dtype=np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    sp = _inputs()
    return sp, run_ranks(sp_suite, 2, tmp_path_factory.mktemp("sp"), sp)


def test_ring_attention_matches_dense(ranks):
    sp, res = ranks
    want = np.asarray(JaxSelfAttention(channels=16).apply(
        {"params": sp["attn_flax"]}, jnp.asarray(sp["attn_x"])))
    for r in res:
        got, dense = r["ring"]   # 64 tokens over 2 ranks
        np.testing.assert_allclose(got, dense, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_ring_attention_rejects_indivisible_tokens(ranks):
    _, res = ranks
    for r in res:   # 13 tokens over 2 ranks
        assert "not divisible" in r["ring_error"]


def test_full_image_sr_matches_unsharded(ranks):
    sp, res = ranks
    want = np.asarray(JaxGenerator(**GEN).apply({"params": sp["gen"]},
                                                jnp.asarray(sp["img"])))
    for r in res:
        got, dense = r["full"]
        assert got.shape == (1, 32, 32, 3)
        np.testing.assert_allclose(got, dense, atol=5e-5, rtol=5e-5)
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)


def test_super_resolve_full_image_blockwise_and_mesh_paths(ranks):
    """H = 16 splits over 2 ranks (the mesh path); H = 17 does not and
    takes the blockwise path, as in JAX."""
    sp, res = ranks
    gen = JaxGenerator(**GEN)
    for name in ("lr16", "lr17"):
        lr = sp[name]
        want = np.clip((np.asarray(gen.apply(
            {"params": sp["gen"]}, jnp.asarray(lr)[None] * 2 - 1))[0] + 1) / 2,
            0, 1)
        for r in res:
            assert r[name].shape == (2 * lr.shape[0], 32, 3)
            np.testing.assert_allclose(r[name], want, atol=5e-5, rtol=5e-5)
            np.testing.assert_allclose(r[name], r[name + "_single"],
                                       atol=5e-5, rtol=5e-5)
