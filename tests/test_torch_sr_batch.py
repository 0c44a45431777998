"""Is the fused f32 SR of an image the same alone (N = 1) as in a batch of
16? Each stage of the fused forward (``edsr_fast``: head, body, the composed
7x7 tail, the border slabs, the clip) runs on the same input at N = 1 and
inside the batch, in both packages: the port's ``fused_sr_stages`` (the
plain twins on the CPU) and JAX's ``make_fused_sr_apply``, split into the
same stages from its own helpers (and equal to it). On the CPU every stage
of both is batch-invariant, bit for bit; the port's N = 1 result is held to
JAX's at the fused-SR tolerance of ``tests/test_torch_edsr.py`` (1e-5). The
same split runs on the card in ``chip_smoke.py`` (``sr_stage_diffs``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import edsr_tree
from tpusr.models import edsr_fast as jfast
from tpusr_torch.bridge import edsr_from_flax
from tpusr_torch.models.edsr_fast import fused_sr_stages, make_fused_sr_apply

SR_ATOL = 1e-5
N, IMAGES = 16, 4


def _jax_stages(params, n_res, scale=4, res_scaling=0.1):
    """JAX's fused forward (``make_fused_sr_apply``, f32) as the port's
    stages, from the JAX package's own helpers."""
    p = jax.tree.map(jnp.asarray, params)
    w_eff, b_eff, pad = jfast.fused_tail_kernel(p, scale)
    slab = 2 * pad + 1

    def body(x):
        head = y = jfast._conv(p["head"], x)
        for i in range(n_res):
            t = jax.nn.relu(jfast._conv(p[f"res{i}"]["conv1"], y))
            y = y + res_scaling * jfast._conv(p[f"res{i}"]["conv2"], t)
        return jfast._conv(p["body"], y) + head

    def tail(y):
        return jax.lax.conv_general_dilated(
            y, w_eff, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b_eff

    def poly(ys):
        return jfast._interleaved_to_poly(jfast._chained_tail(p, ys, scale),
                                          scale)

    def borders(y, z):
        z = z.at[:, :pad].set(poly(y[:, :slab])[:, :pad])
        z = z.at[:, -pad:].set(poly(y[:, -slab:])[:, -pad:])
        z = z.at[:, :, :pad].set(poly(y[:, :, :slab])[:, :, :pad])
        return z.at[:, :, -pad:].set(poly(y[:, :, -slab:])[:, :, -pad:])

    return {"head": lambda x: jfast._conv(p["head"], x), "body": body,
            "tail": tail, "borders": borders,
            "clip": lambda z: jnp.clip(z, 0.0, 1.0)}


def _stage_diffs(st, x, i, to_np, copy):
    """max |N=1 - in the batch of N| per stage for image ``i``, each stage
    run at N = 1 on the batch run's input of that stage."""
    y, z = st["body"](x), st["tail"](st["body"](x))
    full = st["clip"](st["borders"](y, copy(z)))
    one = slice(i, i + 1)
    pairs = {
        "head": (st["head"](x[one]), st["head"](x)[one]),
        "body": (st["body"](x[one]), y[one]),
        "tail": (st["tail"](y[one]), z[one]),
        "borders": (st["borders"](y[one], copy(z[one])),
                    st["borders"](y, copy(z))[one]),
        "sr": (st["clip"](st["borders"](st["body"](x[one]),
                                        st["tail"](st["body"](x[one])))),
               full[one])}
    return {k: float(np.abs(to_np(a) - to_np(b)).max())
            for k, (a, b) in pairs.items()}, to_np(full)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(31)
    _, params = edsr_tree(rng, 4, num_res_blocks=2, num_filters=16)
    x = rng.random((N, 16, 16, 3), dtype=np.float32)
    return params, x


def test_jax_stages_are_its_fused_forward(case):
    params, x = case
    fn, _ = jfast.make_fused_sr_apply(params, 4, dtype=jnp.float32)
    st = _jax_stages(params, 2)
    y = st["body"](jnp.asarray(x))
    got = st["clip"](st["borders"](y, st["tail"](y)))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(fn(jnp.asarray(x))))


def test_port_stages_are_its_fused_forward(case):
    params, x = case
    model = edsr_from_flax(params, 4, device="cpu")
    st = fused_sr_stages(model)
    fn, _ = make_fused_sr_apply(model)
    with torch.inference_mode():
        y = st["body"](torch.from_numpy(x))
        got = st["clip"](st["borders"](y, st["tail"](y)))
        assert torch.equal(got, fn(torch.from_numpy(x)))


@pytest.mark.parametrize("i", range(IMAGES))
def test_every_stage_is_batch_invariant_in_both_packages(case, i):
    params, x = case
    jst = _jax_stages(params, 2)
    dj, _ = _stage_diffs(jst, jnp.asarray(x), i, np.asarray, lambda a: a)
    model = edsr_from_flax(params, 4, device="cpu")
    pst = fused_sr_stages(model)
    with torch.inference_mode():
        dp, full = _stage_diffs(pst, torch.from_numpy(x), i,
                                lambda t: t.numpy(), torch.clone)
        alone = make_fused_sr_apply(model)[0](torch.from_numpy(x[i:i + 1]))
    assert dj == {k: 0.0 for k in dj}, dj
    assert dp == {k: 0.0 for k in dp}, dp
    np.testing.assert_array_equal(alone.numpy(), full[i:i + 1])
    fn_j, _ = jfast.make_fused_sr_apply(params, 4, dtype=jnp.float32)
    want = np.asarray(fn_j(jnp.asarray(x[i:i + 1])))
    np.testing.assert_allclose(alone.numpy(), want, atol=SR_ATOL, rtol=0)
