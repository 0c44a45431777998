"""``tpusr_torch.utils`` against ``tpusr.utils``: ``debug_mode`` raises on
the op that makes the first NaN or Inf, inside its scope only, and
``assert_all_finite`` names the failing leaf's path as JAX does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr import utils as ju
from tpusr_torch import utils as tu


def test_debug_mode_raises_on_the_op_that_makes_a_nan():
    x = torch.tensor([0.0, 1.0])
    y = x * 2.0                          # finite: passes
    with tu.debug_mode():
        z = y + 1.0
        with pytest.raises(FloatingPointError, match=r"\(nan\).*div"):
            _ = x / x                    # 0 / 0
    assert torch.isnan(x / x)[0]         # outside the scope: no check
    assert torch.equal(z, torch.tensor([1.0, 3.0]))
    # JAX raises on the same op
    with ju.debug_mode():
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jnp.asarray([0.0]) / jnp.asarray([0.0]))


def test_debug_mode_raises_on_the_op_that_makes_an_inf():
    x = torch.tensor([1e30, 2.0], dtype=torch.float32)
    with tu.debug_mode():
        with pytest.raises(FloatingPointError, match=r"\(inf\).*mul"):
            _ = x * x                    # overflow, no NaN
        ok = torch.exp(torch.tensor([1.0]))
    assert torch.isfinite(ok).all()
    with tu.debug_mode(nans=False):      # nans=False checks nothing
        assert torch.isinf(x * x)[0]
    with tu.debug_mode(disable_jit=True):
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor([0.0]))


def test_debug_mode_checks_floating_outputs_only_and_sees_autograd():
    w = torch.tensor([1.0, -1.0], requires_grad=True)
    with tu.debug_mode():
        q = torch.arange(4) // 2         # an integer output: not checked
        loss = torch.sqrt(w[:1]).sum()
        loss.backward()                  # the backward's ops are checked too
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(w)
    assert q.dtype == torch.int64 and torch.isfinite(w.grad).all()


@dataclasses.dataclass
class State:
    params: dict
    step: int


@pytest.mark.parametrize("path,want", [
    (("a", "b"), "name:a/b"),
    (("c", 1), "name:c/[1]"),
    (("z",), "name:z"),
])
def test_assert_all_finite_names_the_path_as_jax(path, want):
    def tree(bad, lib):
        t = {"a": {"b": lib.ones(2)}, "c": [lib.ones(1), lib.ones(3)],
             "z": lib.zeros(())}
        node = t
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = lib.asarray([1.0, bad]) if path[-1] != "z" else lib.asarray(bad)
        return t

    for lib, mod in ((jnp, ju), (torch, tu)):
        mod.assert_all_finite(tree(1.0, lib), "name")       # finite: no raise
        with pytest.raises(FloatingPointError) as e:
            mod.assert_all_finite(tree(float("inf"), lib), "name")
        assert str(e.value) == f"non-finite values in {want}"


def test_assert_all_finite_walks_dataclasses_and_mixed_leaves():
    st = State(params={"w": torch.ones(2), "b": np.zeros(3)}, step=3)
    tu.assert_all_finite(st)
    st.params["b"] = np.array([0.0, np.nan, 1.0])
    with pytest.raises(FloatingPointError, match=r"in state:\.params/b$"):
        tu.assert_all_finite(st, "state")
    tu.assert_all_finite({"n": torch.tensor([1, 2]), "none": None})
