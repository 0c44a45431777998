"""Debug and diagnostics helpers (port of ``tpusr/utils.py``).

- ``debug_mode`` raises ``FloatingPointError`` on the first op whose
  floating output holds a NaN or an Inf, as JAX's ``jax_debug_nans`` and
  ``jax_debug_infs`` do. The port checks every op's output in a
  ``TorchDispatchMode``; each check waits for the op, so it is for debugging
  only. A CUDA kernel launched through the port's own bindings
  (``core/_build.py``) is no PyTorch op: the check sees the ops after it.
- ``assert_all_finite`` checks a nested dict / list / tuple / dataclass of
  tensors or arrays on the host and names the failing leaf's path as the JAX
  function does (``name:a/b``, ``[i]`` for a list index).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _FiniteOutputs(TorchDispatchMode):
    """Raise on the first op whose floating output is not finite."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.numel()
                    and (t.is_floating_point() or t.is_complex())
                    and not bool(torch.isfinite(t).all())):
                kind = "nan" if bool(torch.isnan(t).any()) else "inf"
                raise FloatingPointError(
                    f"invalid value ({kind}) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Within the scope, raise ``FloatingPointError`` on the op that makes
    the first NaN or Inf (``nans=False`` checks nothing). ``disable_jit``
    is kept only for parity with the JAX function's signature, so that its
    callers run unchanged: eager PyTorch has no jit to disable, and it
    changes nothing."""
    del disable_jit
    if not nans:
        yield
        return
    with _FiniteOutputs():
        yield


def _leaves_with_path(tree, path: tuple = ()):
    """(path, leaf) pairs of a nested dict / list / tuple / dataclass; each
    path entry is written as ``jax.tree_util`` writes its key: a dict key as
    itself, a sequence index as ``[i]``, a dataclass field as ``.name``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves_with_path(getattr(tree, f.name),
                                         path + (f".{f.name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return True
        return bool(torch.isfinite(leaf).all())
    return bool(np.all(np.isfinite(np.asarray(leaf))))


def assert_all_finite(tree, name: str = "tree"):
    """Host-side finite check over a nested tree (for tests/debug paths)."""
    for path, leaf in _leaves_with_path(tree):
        if not _finite(leaf):
            raise FloatingPointError(
                f"non-finite values in {name}:{'/'.join(path)}")
