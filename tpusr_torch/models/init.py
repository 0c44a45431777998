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
Every draw is made on the device it is given, the model's own: one K5
launch a drawn leaf on the card, the plain samplers on the CPU, bit for bit
the same values. The helpers take that device with no default, and a draw
without one raises: nothing is drawn on the host to be copied afterwards.
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
from tpusr_torch.device import resolve_device


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
    path from the root, the scope's counter and the ``device`` its
    parameters are made on (its children's too). ``draw`` is False for
    ``NO_DRAW``: the scope's parameters are zeros."""

    def __init__(self, key=None, path: tuple = (), device=None):
        self.draw = not (isinstance(key, str) and key == NO_DRAW)
        self.key = None
        if self.draw:
            self.key = DEFAULT_KEY if key is None else prng.as_key(key)
        self.path = tuple(path)
        self.count = 0
        self.device = None if device is None else torch.device(device)

    def child(self, name: str) -> "ParamRng":
        return ParamRng(self.key if self.draw else NO_DRAW,
                        self.path + (name,), self.device)

    def next(self) -> tuple[int, int] | None:
        self.count += 1
        if not self.draw:
            return None
        return _fold_in_static(self.key, self.path + (self.count,))


def param_rng(key, device=None) -> ParamRng:
    """``key`` as a root scope on ``device`` (``resolve_device``'s: the
    card unless the CPU is asked for); a ``ParamRng`` passes through with
    its own device."""
    if isinstance(key, ParamRng):
        return key
    return ParamRng(key, device=resolve_device(device))


def dropout_key(key, path: tuple) -> tuple[int, int]:
    """The key of flax's first ``make_rng('dropout')`` in the scope at
    ``path`` (e.g. ``("Dropout_0",)``) under the ``dropout`` root ``key``."""
    return _fold_in_static(prng.as_key(key), tuple(path) + (1,))


def _fans(shape) -> tuple[int, int]:
    """jax's ``_compute_fans`` (in axis -2, out axis -1)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def draw_device(device) -> torch.device:
    """A draw's device, which every caller names: no draw falls back to
    the CPU."""
    if device is None:
        raise ValueError("models.init: a draw needs the device of the model "
                         "it is drawn for (none given)")
    return torch.device(device)


def variance_scaling(key, shape, scale: float, device) -> torch.Tensor:
    """flax's truncated-normal ``variance_scaling(scale, "fan_in")`` of the
    HWIO or (in, out) ``shape``, drawn on ``device``: ``he_normal`` is
    scale 2, ``lecun_normal`` (the ``nn.Conv``/``nn.Dense`` default) scale
    1."""
    variance = np.float32(scale / _fans(shape)[0])
    stddev = np.sqrt(variance) / np.float32(.87962566103423978)
    return prng.truncated_normal(key, -2.0, 2.0, shape,
                                 draw_device(device)) * float(stddev)


def glorot_uniform(key, shape, device) -> torch.Tensor:
    """flax's ``glorot_uniform`` of the HWIO or (in, out) ``shape``, drawn
    on ``device``: uniform on [-1, 1) times sqrt(3 * variance), variance =
    2 / (fan_in + fan_out)."""
    fan_in, fan_out = _fans(shape)
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    limit = np.sqrt(np.float32(3) * variance)
    return prng.uniform(key, shape, -1.0, 1.0,
                        draw_device(device)) * float(limit)


def dense_params(rng: ParamRng, shape, device, scale: float = 1.0):
    """A flax ``nn.Conv``/``nn.Dense`` scope's (kernel, bias) on
    ``device``: the kernel from the scope's first key (truncated-normal
    variance scaling), the zero bias after the second."""
    dev = draw_device(device)
    bias = torch.zeros(shape[-1], device=dev)
    if not rng.draw:
        return torch.zeros(shape, device=dev), bias
    kernel = variance_scaling(rng.next(), shape, scale, dev)
    rng.next()
    return kernel, bias


class DrawnConv2d(torch.nn.Conv2d):
    """``nn.Conv2d`` whose weights the caller draws: its tensors are made
    uninitialised on the given device and no torch initialiser runs (nor
    ``skip_init``'s meta-device build, whose ``to_empty`` imports sympy on
    its first use in a process: 3.7 s on the H100's host)."""

    def reset_parameters(self) -> None:
        pass


class DrawnLinear(torch.nn.Linear):
    """``nn.Linear`` whose weights the caller draws, as ``DrawnConv2d``."""

    def reset_parameters(self) -> None:
        pass


def drawn_leaves(model: torch.nn.Module) -> int:
    """How many leaves the build of ``model`` from a key drew, one sampler
    call each (one K5 launch on the card): every conv or dense kernel and
    every spectral ``u``; the biases are zeros, drawn from nothing."""
    names = [n for n, _p in model.named_parameters()] + [
        n for n, _b in model.named_buffers()]
    return sum(n.rsplit(".", 1)[-1] in ("kernel", "weight", "u")
               for n in names)
