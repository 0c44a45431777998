"""Checkpointing (port of ``tpusr/train/checkpoint.py``): a tree of tensors
(a ``TrainState`` or ``GANState`` included: parameters, optimiser state and
LR) saved as the JAX package saves it, an Orbax directory, plus a JSON
sidecar of metadata.

``directory/name`` is an Orbax checkpoint (``orbax.py``: OCDBT, zarr and
zstd of the port's own) that the JAX package's ``restore_checkpoint``
reads, and the port reads every one the JAX package's ``save_checkpoint``
writes: a trainer state goes through ``bridge`` into the JAX state's tree
and layouts (flax paths, HWIO kernels, (in, out) Dense kernels, optax's
moments of frozen parameters as zeros, int32 counts, a float32 LR) and
back; any other tree is written as it is. ``directory/name.meta.json``
holds the metadata. A file at ``directory/name`` is the ``torch.save``
tree that earlier versions of the port wrote; it is still read. Keras
``.h5`` interop lives in ``keras_import``/``keras_export``. In a process
group only rank 0 writes (``dist.is_writer``); the other ranks return the
same path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any

import numpy as np
import torch

from tpusr_torch import bridge
from tpusr_torch.dist.mesh import is_writer
from tpusr_torch.train import orbax


def _flatten(tree, prefix: str = "") -> dict:
    """Leaves of a nested dict / list / tuple / dataclass by '/'-joined
    path."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _unflatten_like(target, leaves: dict, prefix: str = ""):
    """``target``'s structure with each leaf taken from ``leaves`` by path;
    a tensor leaf lands on the target leaf's device and dtype, a Python
    number as the target's type."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _unflatten_like(getattr(target, f.name), leaves,
                                    f"{prefix}{f.name}/")
            for f in dataclasses.fields(target)})
    if isinstance(target, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_like(v, leaves, f"{prefix}{i}/")
                            for i, v in enumerate(target))
    if prefix not in leaves:
        raise KeyError(f"checkpoint has no leaf {prefix!r}")
    got = leaves[prefix]
    if isinstance(target, torch.Tensor):
        got = torch.as_tensor(got)
        if tuple(got.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint leaf {prefix!r} has shape "
                             f"{tuple(got.shape)}, the target "
                             f"{tuple(target.shape)}")
        return got.to(device=target.device, dtype=target.dtype).requires_grad_(
            target.requires_grad)
    if isinstance(target, (bool, int, float)) and np.ndim(got) == 0:
        return type(target)(np.asarray(got).item())
    return got


def _host_tree(tree) -> Any:
    """What ``orbax.write`` takes: a trainer state as the JAX package's
    tree, any other tree with its tensors as numpy arrays; every tensor
    copied to the host."""
    if bridge.is_train_state(tree):
        return bridge.train_state_to_jax(tree)
    if bridge.is_gan_state(tree):
        return bridge.gan_state_to_jax(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {str(k): _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, float):         # JAX's default precision
        return np.float32(tree)
    return np.asarray(tree)


def _write(path: str, tree, metadata: dict | None) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    orbax.write(path, tree)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(_jsonable(metadata), f, indent=2)
    return path


def save_checkpoint(directory: str, name: str, tree: Any,
                    metadata: dict | None = None) -> str:
    """Save a tree under directory/name (overwrites); returns the path."""
    path = os.path.abspath(os.path.join(directory, name))
    if not is_writer():
        return path
    return _write(path, _host_tree(tree), metadata)


class AsyncSaveHandle:
    """Handle for an in-flight async checkpoint save."""

    def __init__(self):
        self._done = threading.Event()
        self._path = None
        self._exc: BaseException | None = None

    def wait(self, timeout: float | None = None) -> str:
        """Block until the save completes; re-raises any writer exception.
        Returns the checkpoint path."""
        if not self._done.wait(timeout):
            raise TimeoutError("async checkpoint save still in flight")
        if self._exc is not None:
            raise self._exc
        return self._path

    def done(self) -> bool:
        return self._done.is_set()


def save_checkpoint_async(directory: str, name: str, tree: Any,
                          metadata: dict | None = None) -> AsyncSaveHandle:
    """Save a checkpoint without blocking the training loop on the write.

    The tensors are copied to the host (``detach().to("cpu", copy=True)``)
    before the writer thread starts: the trainers update their state in
    place, so the next step would race a write from the live tensors. The
    encoding, the Orbax write and the metadata run on a daemon thread.

    Call ``handle.wait()`` before relying on the directory (e.g. at fit
    end).
    """
    path = os.path.abspath(os.path.join(directory, name))
    handle = AsyncSaveHandle()
    if not is_writer():
        handle._path = path
        handle._done.set()
        return handle
    host = _host_tree(tree)

    def work():
        try:
            handle._path = _write(path, host, metadata)
        except BaseException as e:  # surfaced at handle.wait()
            handle._exc = e
        finally:
            handle._done.set()

    threading.Thread(target=work, daemon=True).start()
    return handle


def _device_of(tree) -> str:
    for v in _flatten(tree).values():
        if isinstance(v, torch.Tensor):
            return v.device.type
    return "cpu"


def restore_checkpoint(directory: str, name: str, target: Any) -> Any:
    """Restore into the structure of ``target`` (a tree like the saved one,
    e.g. a trainer's ``init_state``): each tensor on the target leaf's device
    and dtype. A trainer state restores from either package's checkpoint;
    the checkpoint's zstd decodes on the target's device."""
    path = os.path.abspath(os.path.join(directory, name))
    if os.path.isfile(path):                # the port's earlier format
        leaves = torch.load(path, map_location="cpu", weights_only=True)
    else:
        tree = orbax.read(path, device=_device_of(target))
        if bridge.is_train_state(target):
            return bridge.train_state_from_jax(tree, target)
        if bridge.is_gan_state(target):
            return bridge.gan_state_from_jax(tree, target)
        leaves = _flatten(tree)
    extra = set(leaves) - set(_flatten(target))
    if extra:
        raise KeyError(f"checkpoint leaves not in the target: {sorted(extra)}")
    return _unflatten_like(target, leaves)


def load_metadata(directory: str, name: str) -> dict | None:
    path = os.path.abspath(os.path.join(directory, name)) + ".meta.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    return obj
