"""Checkpointing (port of ``tpusr/train/checkpoint.py``): a tree of tensors
(a ``TrainState`` included: parameters, optimiser state and LR) saved with
``torch.save``, plus a JSON sidecar of metadata.

The files are the port's own format: ``directory/name`` holds the tree's
leaves by path, on the host; ``directory/name.meta.json`` the metadata.
Orbax and ``.h5`` interop are not ported yet. In a process group only rank
0 writes (``dist.is_writer``); the other ranks return the same path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any

import numpy as np
import torch

from tpusr_torch.dist.mesh import is_writer


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
    a tensor leaf lands on the target leaf's device and dtype."""
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
        if tuple(got.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint leaf {prefix!r} has shape "
                             f"{tuple(got.shape)}, the target "
                             f"{tuple(target.shape)}")
        return got.to(device=target.device, dtype=target.dtype).requires_grad_(
            target.requires_grad)
    return got


def _host_snapshot(tree) -> dict:
    """The tree's leaves by path, every tensor copied to the host."""
    return {k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
            else v for k, v in _flatten(tree).items()}


def _write(path: str, leaves: dict, metadata: dict | None) -> str:
    # the directory is made as Orbax makes it in the JAX package
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(leaves, path)
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
    return _write(path, _host_snapshot(tree), metadata)


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
    ``torch.save`` and the metadata write run on a daemon thread.

    Call ``handle.wait()`` before relying on the file (e.g. at fit end).
    """
    path = os.path.abspath(os.path.join(directory, name))
    handle = AsyncSaveHandle()
    if not is_writer():
        handle._path = path
        handle._done.set()
        return handle
    leaves = _host_snapshot(tree)

    def work():
        try:
            handle._path = _write(path, leaves, metadata)
        except BaseException as e:  # surfaced at handle.wait()
            handle._exc = e
        finally:
            handle._done.set()

    threading.Thread(target=work, daemon=True).start()
    return handle


def restore_checkpoint(directory: str, name: str, target: Any) -> Any:
    """Restore into the structure of ``target`` (a tree like the saved one,
    e.g. a trainer's ``init_state``): each tensor on the target leaf's device
    and dtype."""
    path = os.path.abspath(os.path.join(directory, name))
    leaves = torch.load(path, map_location="cpu", weights_only=True)
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
