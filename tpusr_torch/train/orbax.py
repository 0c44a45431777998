"""Orbax checkpoint directories to and from nested numpy trees: what the
JAX package's ``save_checkpoint`` writes (Orbax 0.11's
``StandardCheckpointer``) and its ``restore_checkpoint`` reads.

    tree = orbax.read(path, device="cuda")   # nested dicts/lists of arrays
    orbax.write(path, tree)

A checkpoint directory holds ``_METADATA`` (JSON: every leaf's key path,
each key with its type, 2 a dict key and 1 a sequence index),
``_CHECKPOINT_METADATA`` (JSON) and an OCDBT database (``ocdbt.py``) of
zarr v2 arrays (``zarr.py``), one per leaf, named by its key path joined
with ``.``. Reading builds the tree from ``_METADATA``'s keys and key
types; zarr3, and a checkpoint written without OCDBT, are refused by
name. Writing makes what Orbax writes (``value_type``
``np.ndarray``), its database at the directory's top, through a temporary
directory renamed into place; an existing checkpoint is replaced.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from tpusr_torch.train import ocdbt, zarr

HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
_VALUE_TYPES = ("np.ndarray", "jax.Array", "scalar")
SEQUENCE, DICT = 1, 2


class OrbaxError(ValueError):
    """A checkpoint directory this reader does not take."""


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "_METADATA"))


def read(path: str, device="cpu"):
    """The tree the checkpoint at ``path`` holds; arrays as numpy, on the
    host (``device`` decodes their zstd literals)."""
    if not is_checkpoint(path):
        raise OrbaxError(f"{path}: no _METADATA, not an Orbax checkpoint")
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt"):
        raise OrbaxError(f"{path}: use_zarr3 {meta.get('use_zarr3')}, "
                         f"use_ocdbt {meta.get('use_ocdbt')}; this reader "
                         f"takes zarr v2 on OCDBT")
    items = ocdbt.read(path)
    root: dict = {}
    kinds: dict = {}                  # id of a node -> its keys' type
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        vtype = entry["value_metadata"]["value_type"]
        if vtype not in _VALUE_TYPES:
            raise OrbaxError(f"{path}: leaf {[k['key'] for k in keys]} of "
                             f"value_type {vtype!r}, not one of "
                             f"{_VALUE_TYPES}")
        node = root
        for k in keys[:-1]:
            kinds[id(node)] = k["key_type"]
            node = node.setdefault(k["key"], {})
        kinds[id(node)] = keys[-1]["key_type"]
        name = ".".join(k["key"] for k in keys)
        node[keys[-1]["key"]] = zarr.read(items, name, device)
    return _with_sequences(root, kinds)


def _with_sequences(node, kinds):
    if not isinstance(node, dict):
        return node
    out = {k: _with_sequences(v, kinds) for k, v in node.items()}
    if kinds.get(id(node)) == SEQUENCE:
        if sorted(out, key=int) != [str(i) for i in range(len(out))]:
            raise OrbaxError(f"sequence with indices {sorted(out)}")
        return [out[str(i)] for i in range(len(out))]
    return out


def _flatten(tree, prefix=()):
    """(keys with their types, leaf) in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + ((str(k), DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + ((str(i), SEQUENCE),))
    else:
        yield prefix, tree


def write(path: str, tree) -> str:
    """``tree`` (nested dicts and lists of arrays) as an Orbax checkpoint at
    ``path``; returns the path."""
    t0 = time.time_ns()
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{t0}"
    items: dict = {}
    tree_meta = {}
    for keys, leaf in _flatten(tree):
        zarr.write(items, ".".join(k for k, _t in keys), np.asarray(leaf))
        tree_meta[str(tuple(k for k, _t in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    os.makedirs(tmp)
    try:
        ocdbt.write(tmp, items)
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": t0,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
        os.rename(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    return path
