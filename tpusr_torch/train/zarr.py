"""zarr v2 arrays on a key-value store (``ocdbt.py``), as tensorstore's
``zarr`` driver keeps them under Orbax.

An array named ``name`` is the JSON ``name/.zarray`` and its chunks
``name/i.j...`` (``name/0`` for a scalar), each the C-order bytes of one
full chunk, zstd-compressed (``zstd.py``) or not. Reading takes chunk grids
of any size, and a missing chunk as the fill value ``null`` (zeros), as
tensorstore reads it. The dtypes are those the port's states and the JAX
package's hold: ``<f4``, ``<f2``, ``bfloat16`` (read widened to float32,
exactly), ``<i4``, ``<i8``, ``|u1`` and ``|b1``. Any other dtype, F order,
another separator than ``.``, another fill value, a filter or another
compressor is refused by name.

Writing makes what Orbax writes: one chunk the shape of the array, zstd,
fill value ``null``.
"""

from __future__ import annotations

import itertools
import json

import numpy as np

from tpusr_torch.train import zstd

DTYPES = {"<f4": np.float32, "<f2": np.float16, "bfloat16": np.uint16,
          "<i4": np.int32, "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_}
_NAMES = {np.dtype(v): k for k, v in DTYPES.items() if k != "bfloat16"}


class ZarrError(ValueError):
    """An array this reader does not take, or whose chunks are corrupt."""


def read(items, name: str, device="cpu") -> np.ndarray:
    """The array ``name`` from ``items`` (a mapping of keys to bytes)."""
    meta = json.loads(items[f"{name}/.zarray"])
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')}, "
                        f"not 2")
    dt = meta["dtype"]
    if dt not in DTYPES:
        raise ZarrError(f"{name}: dtype {dt!r} is not one of {sorted(DTYPES)}")
    if meta.get("filters"):
        raise ZarrError(f"{name}: filters {meta['filters']} not taken")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ZarrError(f"{name}: compressor {comp.get('id')!r} not taken "
                        f"(zstd or none)")
    for key, want in (("order", "C"), ("dimension_separator", "."),
                      ("fill_value", None)):
        if meta.get(key, want) != want:
            raise ZarrError(f"{name}: {key} {meta[key]!r} not taken "
                            f"({want!r})")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ZarrError(f"{name}: chunks {chunks} for shape {shape}")
    np_dt = np.dtype(DTYPES[dt])
    out = np.zeros(shape, np_dt)
    nbytes = int(np.prod(chunks, dtype=np.int64)) * np_dt.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        raw = items.get(key)
        if raw is None:
            continue
        if comp is not None:
            raw = zstd.decompress(raw, max_size=nbytes, device=device)
        if len(raw) != nbytes:
            raise ZarrError(f"{key}: {len(raw)} bytes, a chunk is {nbytes}")
        block = np.frombuffer(raw, np_dt).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    if dt == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def write(items: dict, name: str, array: np.ndarray) -> None:
    """``array`` as Orbax writes it: into ``items``, one zstd chunk."""
    a = np.asarray(array)
    a = a if a.flags.c_contiguous else a.copy(order="C")  # keeps 0-d
    dt = _NAMES.get(a.dtype)
    if dt is None:
        raise ZarrError(f"{name}: dtype {a.dtype} is not one the port "
                        f"writes ({sorted(_NAMES.values())})")
    shape = list(a.shape)
    meta = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dt, "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    items[f"{name}/.zarray"] = json.dumps(
        meta, separators=(",", ":"), sort_keys=True).encode()
    key = ".".join(["0"] * a.ndim) or "0"
    items[f"{name}/{key}"] = zstd.compress(a.tobytes())
