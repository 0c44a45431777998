"""OCDBT of the port's own: the key-value store under tensorstore's
``ocdbt`` driver, which Orbax writes every checkpoint into.

    items = ocdbt.read(directory)               # {key: value bytes}
    ocdbt.write(directory, items)

The layout is that of tensorstore's "OCDBT format" page; tensorstore is
not on the card's machine. A database directory holds ``manifest.ocdbt``
and data files under ``d/``. The manifest holds the configuration and the
newest versions, each the root of a B+tree; a tree's nodes, and values too
large to keep inline, lie in the data files. Manifests and nodes are framed
alike: a magic number, the total length, a format version and a
compression (none or zstd, ``zstd.py``) around the body, then a CRC-32C of
all before it.

Bodies encode their entries column by column in varints: every node has a
table of the data files it names (paths prefix-compressed against the one
before); keys are prefix-compressed against the entry before and relative
to the prefix that the parent gives its subtree. Orbax's root database at
a checkpoint's top names data files under ``ocdbt.process_0/``; every
path is taken relative to the database directory.

Reading takes the newest version. Writing makes one version: the leaves
(one, unless the configuration's node limit splits them, with interior
nodes above), and the values above the inline limit, in one data file. A
manifest that keeps its versions in numbered files is refused by name.
"""

from __future__ import annotations

import hashlib
import os
import struct
import time

import numpy as np

from tpusr_torch.train import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_ROOT = (1 << 64) - 1
# what Orbax's checkpoints use
DEFAULT_CONFIG = {"max_inline_value_bytes": 1024,
                  "max_decoded_node_bytes": 100_000_000,
                  "version_tree_arity_log2": 4, "compression": "zstd"}


class OcdbtError(ValueError):
    """A database that is truncated, corrupt or outside what this reader
    takes."""


# ------------------------------------------------------------------ CRC-32C
def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1)
    return t


_CRC = _crc_table().tolist()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), as the manifest and node footers hold it."""
    c = 0xFFFFFFFF
    tab = _CRC
    for b in bytes(data):
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ------------------------------------------------------------------- framing
class _Reader:
    """Varints and fixed-width fields of a body, each read checked."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if self.pos >= len(self.data) or shift > 63:
                raise OcdbtError("truncated or overlong varint")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError("truncated body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _unframe(buf: bytes, magic: int, what: str) -> bytes:
    if len(buf) < 18:
        raise OcdbtError(f"truncated {what}")
    got, length = struct.unpack(">I", buf[:4])[0], struct.unpack(
        "<Q", buf[4:12])[0]
    if got != magic:
        raise OcdbtError(f"{what}: bad magic {got:#010x}")
    if length != len(buf):
        raise OcdbtError(f"{what}: length {length}, {len(buf)} bytes read")
    if crc32c(buf[:-4]) != struct.unpack("<I", buf[-4:])[0]:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(buf[12:-4])
    if r.varint() != 0:
        raise OcdbtError(f"{what}: unknown format version")
    comp = r.varint()
    body = buf[12 + r.pos:-4]
    if comp == 0:
        return body
    if comp == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: unknown compression {comp}")


def _frame(body: bytes, magic: int, compress: bool) -> bytes:
    if compress:
        body = zstd.compress(body)
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(1 if compress else 0) + body
    length = 4 + 8 + len(rest) + 4
    out = head + struct.pack("<Q", length) + rest
    return out + struct.pack("<I", crc32c(out))


def _read_files(r: _Reader) -> list[str]:
    n = r.varint()
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        p = prev[:prefix[i - 1]] if i else b""
        if i and prefix[i - 1] > len(prev):
            raise OcdbtError("data file path prefix past its predecessor")
        p += r.take(suffix[i])
        if base[i] > len(p):
            raise OcdbtError("data file base path past its path")
        paths.append(p.decode())
        prev = p
    return paths


def _write_files(paths: list[str]) -> bytes:
    enc = [p.encode() for p in paths]
    pre = [len(os.path.commonprefix([enc[i - 1], enc[i]]))
           for i in range(1, len(enc))]
    suf = [len(e) - (pre[i - 1] if i else 0) for i, e in enumerate(enc)]
    return (_varint(len(enc)) + _varints(pre) + _varints(suf)
            + _varints([0] * len(enc))
            + b"".join(e[(pre[i - 1] if i else 0):]
                       for i, e in enumerate(enc)))


def _read_keys(r: _Reader, n: int, interior: bool):
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    sub = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if i and prefix[i - 1] > len(prev):
            raise OcdbtError("key prefix past its predecessor")
        k = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        keys.append(k)
        prev = k
    return keys, sub


def _write_keys(keys: list[bytes]) -> tuple[bytes, bytes]:
    pre = [len(os.path.commonprefix([keys[i - 1], keys[i]]))
           for i in range(1, len(keys))]
    suf = [len(k) - (pre[i - 1] if i else 0) for i, k in enumerate(keys)]
    data = b"".join(k[(pre[i - 1] if i else 0):] for i, k in enumerate(keys))
    return _varints(pre) + _varints(suf), data


# ------------------------------------------------------------------- reading
def read_manifest(directory: str) -> dict:
    """The configuration and newest version's root of the database at
    ``directory``: {"config": {...}, "root": (path, offset, length, height)
    or None for an empty tree, "generation": n}."""
    with open(os.path.join(directory, "manifest.ocdbt"), "rb") as f:
        r = _Reader(_unframe(f.read(), MANIFEST_MAGIC, "manifest.ocdbt"))
    cfg = {"uuid": r.take(16)}
    kind = r.varint()
    cfg["max_inline_value_bytes"] = r.varint()
    cfg["max_decoded_node_bytes"] = r.varint()
    cfg["version_tree_arity_log2"] = r.u8()
    comp = r.varint()
    if comp == 1:
        cfg["compression"] = "zstd"
        cfg["zstd_level"] = struct.unpack("<i", r.take(4))[0]
    elif comp == 0:
        cfg["compression"] = None
    else:
        raise OcdbtError(f"manifest: unknown compression method {comp}")
    if kind != 0:
        raise OcdbtError("manifest keeps its versions in numbered manifest "
                         "files, which this reader does not take")
    files = _read_files(r)
    n = r.varint()
    if not n:
        raise OcdbtError("manifest has no version")
    gen = r.varints(n)
    height = [r.u8() for _ in range(n)]
    fid = r.varints(n)
    off = r.varints(n)
    length = r.varints(n)
    newest = max(range(n), key=lambda i: gen[i])
    if length[newest] == NO_ROOT:
        return {"config": cfg, "root": None, "generation": gen[newest]}
    if fid[newest] >= len(files):
        raise OcdbtError("version names a data file past its table")
    return {"config": cfg, "generation": gen[newest],
            "root": (files[fid[newest]], off[newest], length[newest],
                     height[newest])}


class _Files:
    """Byte ranges of the data files, each opened once."""

    def __init__(self, directory: str):
        self.directory = directory
        self.open: dict = {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        f = self.open.get(path)
        if f is None:
            full = os.path.normpath(os.path.join(self.directory, path))
            if not full.startswith(os.path.normpath(self.directory) + os.sep):
                raise OcdbtError(f"data file {path!r} outside the database")
            f = self.open[path] = open(full, "rb")
        f.seek(offset)
        out = f.read(length)
        if len(out) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} past its end")
        return out

    def close(self):
        for f in self.open.values():
            f.close()


def read(directory: str) -> dict[str, bytes]:
    """Every key of the newest version with its value."""
    m = read_manifest(directory)
    out: dict[str, bytes] = {}
    if m["root"] is None:
        return out
    files = _Files(directory)
    try:
        path, off, length, height = m["root"]
        _read_node(files, path, off, length, height, b"", out)
    finally:
        files.close()
    return out


def _read_node(files: _Files, path, off, length, height, prefix: bytes,
               out: dict) -> None:
    r = _Reader(_unframe(files.read(path, off, length), NODE_MAGIC,
                         f"{path}@{off}"))
    if r.u8() != height:
        raise OcdbtError(f"{path}@{off}: node height is not its parent's")
    paths = _read_files(r)
    n = r.varint()
    keys, sub = _read_keys(r, n, interior=height > 0)

    def refs(count):
        fid = r.varints(count)
        if any(i >= len(paths) for i in fid):
            raise OcdbtError("value names a data file past its table")
        return [paths[i] for i in fid], r.varints(count)
    if height:
        fpaths, offs = refs(n)
        lens = r.varints(n)
        for i in range(n):
            if sub[i] > len(keys[i]):
                raise OcdbtError("subtree prefix past its key")
            _read_node(files, fpaths[i], offs[i], lens[i], height - 1,
                       prefix + keys[i][:sub[i]], out)
        return
    lens = r.varints(n)
    kinds = r.varints(n)
    ind = [i for i in range(n) if kinds[i] == 1]
    if any(k > 1 for k in kinds):
        raise OcdbtError("unknown value kind")
    fpaths, offs = refs(len(ind))
    for j, i in enumerate(ind):
        out[(prefix + keys[i]).decode()] = files.read(fpaths[j], offs[j],
                                                      lens[i])
    for i in range(n):
        if kinds[i] == 0:
            out[(prefix + keys[i]).decode()] = r.take(lens[i])


# ------------------------------------------------------------------- writing
def write(directory: str, items: dict[str, bytes],
          config: dict | None = None) -> None:
    """A new database at ``directory`` holding ``items`` as its one
    version (generation 1)."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    compress = cfg["compression"] == "zstd"
    keys = sorted(k.encode() for k in items)
    vals = [items[k.decode()] for k in keys]
    digest = hashlib.blake2b(digest_size=16)
    for k, v in zip(keys, vals):
        digest.update(struct.pack("<QQ", len(k), len(v)) + k + v)
    name = "d/" + digest.hexdigest()
    blob = bytearray()
    refs = []
    for v in vals:                              # the indirect values first
        if len(v) > cfg["max_inline_value_bytes"]:
            refs.append((len(blob), len(v)))
            blob += v
        else:
            refs.append(None)
    indirect = len(blob)
    level = []                                  # (first key, offset, length,
    for chunk in _split(keys, vals, refs, cfg, name):   # keys, tree bytes)
        node = _frame(_leaf(chunk, name), NODE_MAGIC, compress)
        level.append((chunk[0][0], len(blob), len(node), len(chunk),
                      len(node), sum(len(v) for _k, v, ref in chunk if ref)))
        blob += node
    height = 0
    while len(level) > 1:
        height += 1
        nxt = []
        for group in _groups(level, cfg, name, height):
            node = _frame(_interior(group, name, height), NODE_MAGIC, compress)
            nxt.append((group[0][0], len(blob), len(node),
                        sum(e[3] for e in group),
                        len(node) + sum(e[4] for e in group),
                        sum(e[5] for e in group)))
            blob += node
        level = nxt
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    with open(os.path.join(directory, name), "wb") as f:
        f.write(blob)
    root = level[0]
    body = (digest.digest() + _varint(0)
            + _varints([cfg["max_inline_value_bytes"],
                        cfg["max_decoded_node_bytes"]])
            + bytes([cfg["version_tree_arity_log2"]])
            + (_varint(1) + struct.pack("<i", 0) if compress else _varint(0))
            + _write_files([name])
            + _varints([1, 1]) + bytes([height])
            + _varints([0, root[1], root[2], root[3], root[4], indirect])
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(os.path.join(directory, "manifest.ocdbt"), "wb") as f:
        f.write(_frame(body, MANIFEST_MAGIC, compress))


def _leaf(chunk, name: str) -> bytes:
    """A leaf body: (key, value, (offset, length) or None) entries."""
    keys = [k for k, _v, _r in chunk]
    cols, keydata = _write_keys(keys)
    ind = [r for _k, _v, r in chunk if r]
    return (bytes([0]) + _write_files([name] if ind else [])
            + _varint(len(chunk)) + cols + keydata
            + _varints(len(v) for _k, v, _r in chunk)
            + _varints(1 if r else 0 for _k, _v, r in chunk)
            + _varints([0] * len(ind)) + _varints(o for o, _n in ind)
            + b"".join(v for _k, v, r in chunk if not r))


def _interior(group, name: str, height: int) -> bytes:
    """An interior body over children (first key, offset, length, keys,
    tree bytes, indirect bytes); the subtree prefixes are left empty."""
    cols, keydata = _write_keys([e[0] for e in group])
    return (bytes([height]) + _write_files([name]) + _varint(len(group))
            + cols + _varints([0] * len(group)) + keydata
            + _varints([0] * len(group)) + _varints(e[1] for e in group)
            + _varints(e[2] for e in group) + _varints(e[3] for e in group)
            + _varints(e[4] for e in group) + _varints(e[5] for e in group))


def _split(keys, vals, refs, cfg, name):
    """The entries in leaves whose bodies stay under the node limit."""
    limit = cfg["max_decoded_node_bytes"]
    chunk, size = [], 64 + len(name)
    for k, v, ref in zip(keys, vals, refs):
        est = len(k) + 24 + (0 if ref else len(v))
        if chunk and size + est > limit:
            yield chunk
            chunk, size = [], 64 + len(name)
        chunk.append((k, v, ref))
        size += est
    yield chunk


def _groups(level, cfg, name, height):
    limit = cfg["max_decoded_node_bytes"]
    group, size = [], 64 + len(name)
    for e in level:
        est = len(e[0]) + 48
        if len(group) >= 2 and size + est > limit:
            yield group
            group, size = [], 64 + len(name)
        group.append(e)
        size += est
    yield group
