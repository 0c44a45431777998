"""Weight initialisers of the port, drawing what flax draws: each parameter
from its own key, derived from the root key by the module path as flax's
``LazyRng`` derives it, with ``jax.random``'s streams (``core.prng``).

``ParamRng(key)`` stands for the root scope of ``model.init(key, x)``;
``child(name)`` is a named submodule's scope; each ``next()`` is one
``make_rng('params')`` of that scope (every ``self.param``, zero-initialised
biases included, and the spectral ``u``): ``fold_in(root, h)`` where ``h``
is the first 4 bytes (big-endian) of SHA-1 over the module names and the
scope's counter (``flax/core/scope.py``, ``_fold_in_static``, with
``flax_fix_rng_separator`` off). The same rule gives the ``dropout``
collection's keys (``dropout_key``). ``key=NO_DRAW`` builds a model with
zero weights and draws nothing, for callers that load weights over them.
A model built with no key draws from ``DEFAULT_KEY``, ``PRNGKey(42)``: the
key of the JAX trainers' ``init_state`` when given none (the ESRGAN
generator and discriminator take the two keys of its ``split``, as the JAX
GAN trainer does), and of the facades.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from tpusr_torch.core import prng


def _fold_in_static(key, data) -> tuple[int, int]:
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return prng.fold_in(key, int.from_bytes(m.digest()[:4], "big"))


NO_DRAW = "no draw"
DEFAULT_KEY = prng.PRNGKey(42)


class ParamRng:
    """One flax scope's ``params`` key stream: the root key, the module
    path from the root, and the scope's counter. ``draw`` is False for
    ``NO_DRAW``: the scope's parameters are zeros."""

    def __init__(self, key=None, path: tuple = ()):
        self.draw = not (isinstance(key, str) and key == NO_DRAW)
        self.key = None
        if self.draw:
            self.key = DEFAULT_KEY if key is None else prng.as_key(key)
        self.path = tuple(path)
        self.count = 0

    def child(self, name: str) -> "ParamRng":
        return ParamRng(self.key if self.draw else NO_DRAW,
                        self.path + (name,))

    def next(self) -> tuple[int, int] | None:
        self.count += 1
        if not self.draw:
            return None
        return _fold_in_static(self.key, self.path + (self.count,))


def param_rng(key) -> ParamRng:
    """``key`` as a root scope (a ``ParamRng`` passes through)."""
    return key if isinstance(key, ParamRng) else ParamRng(key)


def dropout_key(key, path: tuple) -> tuple[int, int]:
    """The key of flax's first ``make_rng('dropout')`` in the scope at
    ``path`` (e.g. ``("Dropout_0",)``) under the ``dropout`` root ``key``."""
    return _fold_in_static(prng.as_key(key), tuple(path) + (1,))


def _fans(shape) -> tuple[int, int]:
    """jax's ``_compute_fans`` (in axis -2, out axis -1)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(key, shape, scale: float) -> torch.Tensor:
    """flax's truncated-normal ``variance_scaling(scale, "fan_in")`` of the
    HWIO or (in, out) ``shape``, on the CPU: ``he_normal`` is scale 2,
    ``lecun_normal`` (the ``nn.Conv``/``nn.Dense`` default) scale 1."""
    variance = np.float32(scale / _fans(shape)[0])
    stddev = np.sqrt(variance) / np.float32(.87962566103423978)
    return prng.truncated_normal(key, -2.0, 2.0, shape) * float(stddev)


def glorot_uniform(key, shape) -> torch.Tensor:
    """flax's ``glorot_uniform`` of the HWIO or (in, out) ``shape``, on the
    CPU: uniform on [-1, 1) times sqrt(3 * variance), variance = 2 /
    (fan_in + fan_out)."""
    fan_in, fan_out = _fans(shape)
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    limit = np.sqrt(np.float32(3) * variance)
    return prng.uniform(key, shape, -1.0, 1.0) * float(limit)


def dense_params(rng: ParamRng, shape, scale: float = 1.0):
    """A flax ``nn.Conv``/``nn.Dense`` scope's (kernel, bias): the kernel
    from the scope's first key (truncated-normal variance scaling), the
    zero bias after the second."""
    if not rng.draw:
        return torch.zeros(shape), torch.zeros(shape[-1])
    kernel = variance_scaling(rng.next(), shape, scale)
    rng.next()
    return kernel, torch.zeros(shape[-1])
