"""The port's OCDBT store and zarr arrays (``tpusr_torch/train/ocdbt.py``,
``zarr.py``) against tensorstore, on the CPU.

- stores that tensorstore writes (nodes small enough that the tree has
  interior nodes; inline and indirect values; no compression and zstd;
  several versions) read as tensorstore reads their newest version;
- tensorstore reads the port's stores back to the same key-value pairs,
  with and without interior nodes and compression;
- CRC-32C's check value; a corrupt manifest and a manifest of numbered
  versions raise naming what is wrong;
- zarr v2 arrays that tensorstore writes on OCDBT (grids of several
  chunks, a missing chunk read as the fill value, each dtype the port
  takes, no compressor) read equal; another dtype is refused by name.
"""

import os

import numpy as np
import pytest

from tpusr_torch.train import ocdbt, zarr

ts = pytest.importorskip("tensorstore")


def _ts_items(path) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    return {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}


def _items(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"params.layer{i:03d}.{leaf}/{part}": rng.integers(
        0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
            for i in range(n) for leaf in ("kernel", "bias")
            for part in (".zarray", "0.0")}


@pytest.mark.parametrize("compression", [None, {"id": "zstd"}])
def test_reads_tensorstore_stores_with_interior_nodes_and_versions(
        tmp_path, compression):
    cfg = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 100,
           "compression": compression}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": cfg}).result()
    items = _items(0, 30)
    with ts.Transaction() as txn:
        for k, v in items.items():
            kv.with_transaction(txn)[k] = v
    for j in range(20):                  # more versions than one node holds
        kv[f"later/{j:02d}"] = bytes([j]) * j
    del kv[sorted(items)[3]]
    man = ocdbt.read_manifest(str(tmp_path))
    assert man["generation"] == 23 and man["root"][3] > 0   # interior nodes
    got = ocdbt.read(str(tmp_path))
    assert got == _ts_items(tmp_path)
    assert len(got) == len(items) - 1 + 20


@pytest.mark.parametrize("config", [None,
                                    {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 50},
                                    {"compression": None}])
def test_tensorstore_reads_the_port_store(tmp_path, config):
    items = _items(1, 40)
    ocdbt.write(str(tmp_path), items, config)
    assert _ts_items(tmp_path) == items
    assert ocdbt.read(str(tmp_path)) == items
    height = ocdbt.read_manifest(str(tmp_path))["root"][3]
    assert (height > 0) == bool(config and "max_decoded_node_bytes" in config)


def test_crc32c_and_corrupt_or_numbered_manifests(tmp_path):
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    ocdbt.write(str(tmp_path / "a"), {"k": b"v"})
    man = tmp_path / "a" / "manifest.ocdbt"
    buf = bytearray(man.read_bytes())
    buf[20] ^= 1
    man.write_bytes(bytes(buf))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.read(str(tmp_path / "a"))
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/n/",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv["k"] = b"v"
    with pytest.raises(ocdbt.OcdbtError, match="numbered"):
        ocdbt.read(str(tmp_path / "n"))


DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32,
          "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_}


def _ts_zarr(path, name, shape, chunks, dtype, compressor, data=None,
             region=None):
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "ocdbt", "base": f"file://{path}/",
                               "path": name + "/"},
                   "metadata": {"shape": list(shape), "chunks": list(chunks),
                                "dtype": dtype, "compressor": compressor,
                                "fill_value": None}},
                  create=True, open=True).result()
    if data is not None:
        sl = region or tuple(slice(0, s) for s in shape)
        arr[sl].write(data).result()


class _Items(dict):
    def get(self, k, default=None):
        return super().get(k, default)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 3}])
def test_zarr_arrays_that_tensorstore_writes(tmp_path, dtype, compressor):
    rng = np.random.default_rng(5)
    shape, chunks = (7, 5, 3), (3, 2, 3)          # a grid of 3 x 3 chunks
    a = (rng.standard_normal(shape) * 100).astype(DTYPES[dtype])
    _ts_zarr(tmp_path, "w", shape, chunks, dtype, compressor, a)
    # only the first rows: the chunks below them are never written
    _ts_zarr(tmp_path, "part", shape, chunks, dtype, compressor, a[:3],
             (slice(0, 3), slice(0, 5), slice(0, 3)))
    items = _Items(ocdbt.read(str(tmp_path)))
    assert not any(k.startswith("part/2.") for k in items)
    np.testing.assert_array_equal(zarr.read(items, "w"), a)
    want = np.zeros_like(a)
    want[:3] = a[:3]
    got = zarr.read(items, "part")
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, want)


def test_zarr_bfloat16_widens_and_other_dtypes_are_refused(tmp_path):
    import ml_dtypes
    a = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    b16 = a.astype(ml_dtypes.bfloat16)
    _ts_zarr(tmp_path, "b", (3, 4), (2, 4), "bfloat16", {"id": "zstd"}, b16)
    _ts_zarr(tmp_path, "d", (2,), (2,), "<f8", None, np.ones(2))
    items = _Items(ocdbt.read(str(tmp_path)))
    got = zarr.read(items, "b")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, b16.astype(np.float32))
    with pytest.raises(zarr.ZarrError, match="dtype '<f8'"):
        zarr.read(items, "d")
    with pytest.raises(zarr.ZarrError, match="float64"):
        zarr.write({}, "d", np.ones(2))


def test_zarr_write_is_what_orbax_writes(tmp_path):
    items = {}
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    zarr.write(items, "params.a.kernel", a)
    zarr.write(items, "step", np.int32(3))
    assert sorted(items) == ["params.a.kernel/.zarray",
                             "params.a.kernel/0.0.0", "step/.zarray",
                             "step/0"]
    assert items["step/.zarray"] == (
        b'{"chunks":[],"compressor":{"id":"zstd","level":1},'
        b'"dimension_separator":".","dtype":"<i4","fill_value":null,'
        b'"filters":null,"order":"C","shape":[],"zarr_format":2}')
    ocdbt.write(str(tmp_path), items)
    arr = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "path": "params.a.kernel/"}}).result()
    np.testing.assert_array_equal(arr.read().result(), a)
    assert os.path.isdir(tmp_path / "d")
