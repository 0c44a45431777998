"""An HDF5 reader and writer of the port's own, for Keras ``.h5`` models.

The JAX package reads Keras files through h5py and writes them through
TensorFlow; neither is on the card's machine. This module is pure Python
over numpy (``zlib`` for the deflate filter), with the small tree API that
``keras_import``/``keras_export`` and the ImageNet tool need:

    with hdf5.File(path) as f:                  # read
        names = f["model_weights"].attrs["layer_names"]
        kernel = np.asarray(f["model_weights/conv1/sequential/conv1/kernel"])

    with hdf5.File(path, "w") as f:             # write
        f.attrs["backend"] = "tensorflow"        # str: variable-length UTF-8
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = [b"conv1"]      # bytes: variable-length ASCII
        g.create_dataset("conv1/kernel", data=kernel)

Reading covers what h5py 3 and a decade of Keras releases write: superblock
v0-v3; object headers v1 (with continuations) and v2; old-style groups (a
symbol table, a v1 B-tree of any depth, ``SNOD`` nodes, a local heap) and
new-style groups (link messages, or dense storage: a fractal heap indexed by
a v2 B-tree); attribute messages v1-v3, compact or dense; fixed-point and
IEEE float (either byte order), fixed-length and variable-length strings (a
global heap); scalar, simple and null dataspaces; contiguous, compact and
chunked layouts (chunks indexed by a v1 B-tree) with the deflate and
shuffle filters; an unallocated dataset reads as its fill
value. Arrays come out through ``np.frombuffer`` over the file's bytes
(read-only). ``keys()`` and ``attrs.keys()`` give h5py's order: by name,
or by creation order where the object tracks it.

Every field read from the file is checked before it sizes a read or an
allocation: a truncated or crafted file raises ``ValueError``. A chunked
dataset may inflate to at most ``MAX_INFLATE`` times the file's size.

Writing produces what h5py writes with ``libver="earliest"``, its default:
superblock v0, object headers v1, symbol-table groups with a v1 B-tree of
any depth (leaf K 4, internal K 16), local heaps, contiguous datasets and
one global heap for the variable-length strings. Attribute values take the
types h5py gives the same Python values (``_value_type``).
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = (1 << 64) - 1
MAX_INFLATE = 1100          # > zlib's largest ratio, 1032
_LEAF_K, _INTERNAL_K = 4, 16  # h5py's group B-tree K values
_FREE_NULL = 1              # a local heap's "no free block"


class Empty:
    """An attribute or dataset with a null dataspace (``h5py.Empty``)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)
        self.shape = None

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ------------------------------------------------------------------ types
class _Type:
    """A decoded datatype message: ``kind`` is 'int', 'float', 'str' (fixed
    length) or 'vlen-str'; ``dtype`` the numpy dtype of one element as
    stored (16 bytes of heap reference for 'vlen-str')."""

    __slots__ = ("kind", "size", "dtype", "cset", "pad")

    def __init__(self, kind, size, dtype, cset=0, pad=0):
        self.kind, self.size, self.dtype = kind, size, dtype
        self.cset, self.pad = cset, pad

    def describe(self) -> str:
        cset = {0: "ascii", 1: "utf8"}.get(self.cset, str(self.cset))
        if self.kind == "vlen-str":
            return f"vlen-str/{cset}"
        if self.kind == "str":
            pad = {0: "nullterm", 1: "nullpad", 2: "spacepad"}.get(
                self.pad, str(self.pad))
            return f"str{self.size}/{pad}/{cset}"
        return self.dtype.str


_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length sequence",
                10: "array", 11: "complex"}


class _Cur:
    """A bounded little-endian cursor over the file's bytes."""

    __slots__ = ("r", "pos", "end")

    def __init__(self, r: "_Reader", pos: int, end: int):
        if pos < 0 or end > r.size or pos > end:
            raise ValueError(f"{r.name}: a structure at {pos} runs past the "
                             f"end of the file ({r.size} bytes)")
        self.r, self.pos, self.end = r, pos, end

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise ValueError(f"{self.r.name}: truncated structure at "
                             f"{self.pos} (wants {n} bytes, has "
                             f"{self.end - self.pos})")
        b = self.r.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def addr(self) -> int:
        n = self.r.so
        v = self.u(n)
        return UNDEF if v == (1 << (8 * n)) - 1 else v

    def length(self) -> int:
        return self.u(self.r.sl)

    def skip(self, n: int) -> None:
        self.take(n)

    def sig(self, want: bytes) -> None:
        got = self.take(len(want))
        if got != want:
            raise ValueError(f"{self.r.name}: expected {want!r} at "
                             f"{self.pos - len(want)}, found {got!r}")


# ------------------------------------------------------------------ reader
class _Reader:
    """The parsed superblock and the caches of one open file."""

    def __init__(self, data: bytes, name: str):
        self.data, self.size, self.name = data, len(data), name
        self._headers: dict = {}
        self._gheaps: dict = {}
        self._fheaps: dict = {}
        self.file = self
        self.leaf_k = self.internal_k = None
        sb = None
        off = 0
        while off + 8 <= self.size:
            if data[off:off + 8] == SIGNATURE:
                sb = off
                break
            off = 512 if off == 0 else off * 2
        if sb is None:
            raise ValueError(f"{name}: not an HDF5 file (no superblock "
                             f"signature)")
        self.so = self.sl = 8
        c = _Cur(self, sb + 8, self.size)
        version = c.u(1)
        if version in (0, 1):
            c.skip(4)
            self.so, self.sl = c.u(1), c.u(1)
            self._check_sizes()
            c.skip(1)
            self.leaf_k, self.internal_k = c.u(2), c.u(2)
            if not self.leaf_k or not self.internal_k:
                raise ValueError(f"{name}: group B-tree K of 0")
            c.skip(4)
            if version == 1:
                c.skip(4)
            self.base = c.addr()
            c.addr(), c.addr(), c.addr()   # free space, end of file, driver
            c.length()                       # the root entry's name offset
            self.root = c.addr()
        elif version in (2, 3):
            self.so, self.sl = c.u(1), c.u(1)
            self._check_sizes()
            c.skip(1)
            self.base = c.addr()
            c.addr(), c.addr()               # extension, end of file
            self.root = c.addr()
        else:
            raise ValueError(f"{name}: superblock version {version} is not "
                             f"supported")
        if self.base == UNDEF or self.root == UNDEF:
            raise ValueError(f"{name}: undefined base or root address")

    def _check_sizes(self):
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"{self.name}: sizes of offsets/lengths "
                             f"{self.so}/{self.sl} are not supported")

    def at(self, addr: int, end: int | None = None) -> _Cur:
        if addr == UNDEF:
            raise ValueError(f"{self.name}: an undefined address is read")
        p = self.base + addr
        return _Cur(self, p, self.size if end is None else p + end)

    # -------------------------------------------------- object headers
    def header(self, addr: int) -> tuple[list, bool]:
        """([(type, flags, creation order, start, end)] of the object's
        messages, continuation chunks followed; whether the object tracks
        its attributes' creation order)."""
        if addr in self._headers:
            return self._headers[addr]
        c = self.at(addr)
        msgs, chunks, seen = [], [], set()
        if self.data[c.pos:c.pos + 4] == b"OHDR":
            c.skip(4)
            if c.u(1) != 2:
                raise ValueError(f"{self.name}: object header v2 version")
            flags = c.u(1)
            if flags & 0x20:
                c.skip(16)
            if flags & 0x10:
                c.skip(4)
            size0 = c.u(1 << (flags & 3))
            chunks.append((c.pos, c.pos + size0))
            v2, crt = True, bool(flags & 0x04)
        else:
            if c.u(1) != 1:
                raise ValueError(f"{self.name}: object header at {addr} has "
                                 f"an unknown version")
            c.skip(7)           # reserved, message count, reference count
            size0 = c.u(4)
            c.skip(4)           # the first chunk is 8-aligned
            chunks.append((c.pos, c.pos + size0))
            v2 = crt = False
        i = 0
        while i < len(chunks):
            start, end = chunks[i]
            i += 1
            if len(chunks) > 4096:
                raise ValueError(f"{self.name}: too many header chunks")
            c = _Cur(self, start, end)
            hdr = (4 + (2 if crt else 0)) if v2 else 8
            while c.end - c.pos >= hdr:
                if v2:
                    mtype, msize, mflags = c.u(1), c.u(2), c.u(1)
                    order = c.u(2) if crt else None
                else:
                    mtype, msize, mflags = c.u(2), c.u(2), c.u(1)
                    c.skip(3)
                    order = None
                body = c.pos
                c.skip(msize)
                if mtype == 0x10:
                    cc = _Cur(self, body, body + msize)
                    caddr, clen = cc.addr(), cc.length()
                    if caddr in seen:
                        raise ValueError(f"{self.name}: a header "
                                         f"continuation loops")
                    seen.add(caddr)
                    p = self.at(caddr, clen)
                    if v2:
                        p.sig(b"OCHK")
                        chunks.append((p.pos, p.end - 4))
                    else:
                        chunks.append((p.pos, p.end))
                elif mtype != 0:
                    msgs.append((mtype, mflags, order, body, body + msize))
        self._headers[addr] = (msgs, crt)
        return self._headers[addr]

    # -------------------------------------------------- messages
    def datatype(self, c: _Cur, depth: int = 0) -> _Type:
        if depth > 4:
            raise ValueError(f"{self.name}: datatype nested too deep")
        cv = c.u(1)
        cls, bits, size = cv & 0x0F, c.u(3), c.u(4)
        if cls == 0:
            c.skip(4)
            if size not in (1, 2, 4, 8):
                raise ValueError(f"{self.name}: integer of {size} bytes")
            kind = "i" if bits & 0x08 else "u"
            return _Type("int", size, np.dtype(f"{'<>'[bits & 1]}{kind}{size}"))
        if cls == 1:
            c.skip(12)
            if size not in (4, 8) or bits & 0x40:
                raise ValueError(f"{self.name}: float of {size} bytes "
                                 f"(bit field {bits:#x}) is not supported")
            return _Type("float", size, np.dtype(f"{'<>'[bits & 1]}f{size}"))
        if cls == 3:
            if size < 1:
                raise ValueError(f"{self.name}: a string of 0 bytes")
            return _Type("str", size, np.dtype(f"S{size}"),
                         cset=(bits >> 4) & 0x0F, pad=bits & 0x0F)
        if cls == 9:
            base = self.datatype(c, depth + 1)
            if bits & 0x0F != 1:
                raise ValueError(f"{self.name}: variable-length sequences "
                                 f"of {base.describe()} are not supported")
            if size != 4 + self.so + 4:
                raise ValueError(f"{self.name}: a variable-length string "
                                 f"reference of {size} bytes")
            return _Type("vlen-str", size, np.dtype(f"V{size}"),
                         cset=(bits >> 8) & 0x0F, pad=(bits >> 4) & 0x0F)
        raise ValueError(f"{self.name}: the {_CLASS_NAMES.get(cls, cls)} "
                         f"datatype class is not supported")

    def dataspace(self, c: _Cur):
        """The shape: a tuple, () for a scalar, None for a null space."""
        version, rank, flags = c.u(1), c.u(1), c.u(1)
        if version == 1:
            c.skip(5)
            null = False
        elif version == 2:
            kind = c.u(1)
            if kind > 2:
                raise ValueError(f"{self.name}: dataspace type {kind}")
            null = kind == 2
        else:
            raise ValueError(f"{self.name}: dataspace version {version}")
        if rank > 32:
            raise ValueError(f"{self.name}: dataspace of rank {rank}")
        shape = tuple(c.length() for _ in range(rank))
        return None if null else shape

    def attribute(self, start: int, end: int):
        """(name, _Type, shape, data start, data end) of a message."""
        c = _Cur(self, start, end)
        version = c.u(1)
        if version not in (1, 2, 3):
            raise ValueError(f"{self.name}: attribute message version "
                             f"{version}")
        flags = c.u(1)
        if version > 1 and flags & 0x03:
            raise ValueError(f"{self.name}: shared attribute datatypes or "
                             f"dataspaces are not supported")
        nlen, tlen, slen = c.u(2), c.u(2), c.u(2)
        if version == 3:
            c.skip(1)
        pad = _pad8 if version == 1 else (lambda n: n)
        name = c.take(nlen)
        c.skip(pad(nlen) - nlen)
        t = self.datatype(_Cur(self, c.pos, min(c.pos + tlen, end)))
        c.skip(pad(tlen))
        shape = self.dataspace(_Cur(self, c.pos, min(c.pos + slen, end)))
        c.skip(pad(slen))
        return (name.split(b"\0", 1)[0].decode("utf-8"), t, shape, c.pos, end)

    # -------------------------------------------------- values
    def _count(self, shape) -> int:
        n = 1
        for d in shape:
            n *= d
        if n > (1 << 62):
            raise ValueError(f"{self.name}: dataspace of {n} elements")
        return n

    def values(self, t: _Type, shape, start: int, end: int, attr: bool):
        """The elements stored at [start, end), as h5py returns them."""
        if shape is None:
            return Empty(t.dtype if t.kind != "vlen-str" else "O")
        n = self._count(shape)
        if n * t.size > end - start:
            raise ValueError(f"{self.name}: {n} elements of {t.size} bytes "
                             f"in {end - start} bytes")
        if t.kind != "vlen-str":
            a = np.frombuffer(self.data, t.dtype, n, start).reshape(shape)
            if attr:
                return a[()] if shape == () else a.copy()
            return a
        items = [self.vlen(start + i * t.size) for i in range(n)]
        if attr:
            items = [b.decode("utf-8", "surrogateescape") for b in items]
        if shape == ():
            return items[0]
        out = np.empty(n, dtype=object)
        out[:] = items
        return out.reshape(shape)

    def vlen(self, pos: int) -> bytes:
        c = _Cur(self, pos, pos + 8 + self.so)
        length, caddr, index = c.u(4), c.addr(), c.u(4)
        if length == 0:
            return b""
        objs = self.file.gheap(caddr)
        if index not in objs:
            raise ValueError(f"{self.name}: global heap object {index} of "
                             f"the collection at {caddr} is missing")
        if length > len(objs[index]):
            raise ValueError(f"{self.name}: a string of {length} bytes in a "
                             f"heap object of {len(objs[index])}")
        return objs[index][:length].split(b"\0", 1)[0]   # a C string, as h5py

    def gheap(self, addr: int) -> dict:
        if addr in self._gheaps:
            return self._gheaps[addr]
        c = self.at(addr)
        c.sig(b"GCOL")
        if c.u(1) != 1:
            raise ValueError(f"{self.name}: global heap version")
        c.skip(3)
        size = c.length()
        if size < 16:
            raise ValueError(f"{self.name}: global heap of {size} bytes")
        start = c.pos - 16
        c = _Cur(self, c.pos, start + size)
        objs = {}
        while c.end - c.pos >= 16:
            index = c.u(2)
            c.skip(6)
            osize = c.length()
            if index == 0:
                break
            objs[index] = c.take(osize)
            c.skip(min(_pad8(osize) - osize, c.end - c.pos))
        self._gheaps[addr] = objs
        return objs

    # -------------------------------------------------- local heaps, B-trees
    def local_heap(self, addr: int):
        c = self.at(addr)
        c.sig(b"HEAP")
        if c.u(1) != 0:
            raise ValueError(f"{self.name}: local heap version")
        c.skip(3)
        size = c.length()
        c.length()
        data = c.addr()
        return self.at(data, size)

    def heap_name(self, heap: _Cur, offset: int) -> str:
        if offset >= heap.end - heap.pos:
            raise ValueError(f"{self.name}: a name offset {offset} past the "
                             f"local heap")
        p = heap.pos + offset
        z = self.data.find(b"\0", p, heap.end)
        if z < 0:
            raise ValueError(f"{self.name}: an unterminated name in a local "
                             f"heap")
        return self.data[p:z].decode("utf-8")

    def v1_btree(self, addr: int, node_type: int, key_size: int,
                 level: int | None = None, seen: set | None = None):
        """Yield (left key bytes, child address) for the leaves of a v1
        B-tree, in order."""
        seen = set() if seen is None else seen
        if addr in seen:
            raise ValueError(f"{self.name}: a B-tree node is its own "
                             f"descendant")
        seen.add(addr)
        c = self.at(addr)
        c.sig(b"TREE")
        ntype, nlevel, used = c.u(1), c.u(1), c.u(2)
        if ntype != node_type or (level is not None and nlevel != level):
            raise ValueError(f"{self.name}: B-tree node at {addr}: type "
                             f"{ntype} level {nlevel}, expected {node_type} "
                             f"level {level}")
        k = self.internal_k if node_type == 0 else None
        if k and used > 2 * k:
            raise ValueError(f"{self.name}: a B-tree node with {used} "
                             f"children (K {k})")
        c.addr(), c.addr()
        entries = []
        for _ in range(used):
            key = c.take(key_size)
            entries.append((key, c.addr()))
        for key, child in entries:
            if nlevel:
                yield from self.v1_btree(child, node_type, key_size,
                                         nlevel - 1, seen)
            else:
                yield key, child

    def symbol_table(self, btree: int, heap_addr: int) -> list:
        """[(name, link)] of an old-style group, by name."""
        heap = self.local_heap(heap_addr)
        out = []
        for _key, snod in self.v1_btree(btree, 0, self.sl):
            c = self.at(snod)
            c.sig(b"SNOD")
            if c.u(1) != 1:
                raise ValueError(f"{self.name}: symbol node version")
            c.skip(1)
            n = c.u(2)
            if self.leaf_k and n > 2 * self.leaf_k:
                raise ValueError(f"{self.name}: a symbol node with {n} "
                                 f"entries (K {self.leaf_k})")
            for _ in range(n):
                name_off, obj = c.length(), c.addr()
                cache = c.u(4)
                c.skip(4)
                c.skip(16)
                out.append((self.heap_name(heap, name_off),
                            ("soft" if cache == 2 else "hard", obj)))
        return out

    # -------------------------------------------------- fractal heaps
    def fractal_heap(self, addr: int) -> dict:
        if addr in self._fheaps:
            return self._fheaps[addr]
        c = self.at(addr)
        c.sig(b"FRHP")
        if c.u(1) != 0:
            raise ValueError(f"{self.name}: fractal heap version")
        h = {"id_len": c.u(2), "filter_len": c.u(2), "flags": c.u(1),
             "max_man": c.u(4)}
        c.length()                  # the next huge object ID
        h["huge_bt"] = c.addr()
        # free space, its manager, managed space, allocated, the allocation
        # offset, then the managed, huge and tiny objects' sizes and counts
        for _ in range(10):
            c.addr() if _ == 1 else c.length()
        h["width"] = c.u(2)
        h["start"], h["max_direct"] = c.length(), c.length()
        h["max_bits"] = c.u(2)
        c.u(2)
        h["root"], h["rows"] = c.addr(), c.u(2)
        w, s, md = h["width"], h["start"], h["max_direct"]
        for v in (w, s, md):
            if v <= 0 or v & (v - 1):
                raise ValueError(f"{self.name}: fractal heap doubling table "
                                 f"{w}/{s}/{md}")
        if h["filter_len"]:
            raise ValueError(f"{self.name}: a filtered fractal heap is not "
                             f"supported")
        if not 0 < h["max_bits"] <= 64:
            raise ValueError(f"{self.name}: fractal heap of 2^"
                             f"{h['max_bits']} bytes")
        h["off_size"] = (h["max_bits"] + 7) // 8
        h["len_size"] = min((md.bit_length() - 1 + 7) // 8,
                            (h["max_man"].bit_length() - 1) // 8 + 1)
        h["direct_rows"] = (md.bit_length() - s.bit_length()) + 2
        so, sl = self.so, self.sl
        if so + sl <= h["id_len"] - 1:
            h["huge_direct"], h["huge_id"] = True, so + sl
        else:
            h["huge_direct"], h["huge_id"] = False, min(h["id_len"] - 1, 8)
        h["huge"] = None
        self._fheaps[addr] = h
        return h

    def _block_size(self, h, row):
        return h["start"] if row == 0 else h["start"] << (row - 1)

    def heap_object(self, heap_addr: int, hid: bytes) -> bytes:
        h = self.fractal_heap(heap_addr)
        if len(hid) < 1:
            raise ValueError(f"{self.name}: an empty heap ID")
        kind = (hid[0] >> 4) & 3
        if hid[0] >> 6:
            raise ValueError(f"{self.name}: heap ID version {hid[0] >> 6}")
        if kind == 2:                                   # tiny
            if h["id_len"] - 1 > 16:
                n, body = ((hid[0] & 0x0F) << 8 | hid[1]) + 1, hid[2:]
            else:
                n, body = (hid[0] & 0x0F) + 1, hid[1:]
            if n > len(body):
                raise ValueError(f"{self.name}: a tiny heap object overruns "
                                 f"its ID")
            return body[:n]
        if kind == 1:                                   # huge
            if h["huge_direct"]:
                a = int.from_bytes(hid[1:1 + self.so], "little")
                n = int.from_bytes(hid[1 + self.so:1 + self.so + self.sl],
                                   "little")
            else:
                key = int.from_bytes(hid[1:1 + h["huge_id"]], "little")
                if h["huge"] is None:
                    h["huge"] = {}
                    for rec in self.v2_btree(h["huge_bt"]):
                        rc = _Cur(self, rec[0], rec[1])
                        a, n = rc.addr(), rc.length()
                        h["huge"][rc.length()] = (a, n)
                if key not in h["huge"]:
                    raise ValueError(f"{self.name}: huge heap object {key} "
                                     f"is not indexed")
                a, n = h["huge"][key]
            c = self.at(a, n)
            return c.take(n)
        if kind != 0:
            raise ValueError(f"{self.name}: heap ID type {kind}")
        offset = int.from_bytes(hid[1:1 + h["off_size"]], "little")
        length = int.from_bytes(
            hid[1 + h["off_size"]:1 + h["off_size"] + h["len_size"]], "little")
        block, block_off, size = self._direct_block(h, offset)
        rel = offset - block_off
        if rel + length > size:
            raise ValueError(f"{self.name}: a heap object overruns its block")
        c = self.at(block, size)
        c.skip(rel)
        return c.take(length)

    def _direct_block(self, h, offset):
        """(address, heap offset, size) of the direct block that holds
        ``offset``, walking the doubling table from the root."""
        w, s = h["width"], h["start"]
        if h["rows"] == 0:
            return h["root"], 0, s
        addr, base, rows = h["root"], 0, h["rows"]
        for _ in range(64):
            rel = offset - base
            row = (rel // (w * s)).bit_length()
            if row >= rows:
                raise ValueError(f"{self.name}: heap offset {offset} is past "
                                 f"its indirect block")
            row_start = 0 if row == 0 else w * s << (row - 1)
            bsize = self._block_size(h, row)
            col = (rel - row_start) // bsize
            c = self.at(addr)
            c.sig(b"FHIB")
            c.skip(1 + self.so + h["off_size"])
            nd = min(rows, h["direct_rows"]) * w
            if row < h["direct_rows"]:
                c.skip((row * w + col) * self.so)
                child = c.addr()
                if child == UNDEF:
                    raise ValueError(f"{self.name}: an unallocated heap "
                                     f"block is read")
                return child, base + row_start + col * bsize, bsize
            c.skip((nd + (row - h["direct_rows"]) * w + col) * self.so)
            addr = c.addr()
            base = base + row_start + col * bsize
            rows = (bsize.bit_length() - (s * w).bit_length()) + 1
        raise ValueError(f"{self.name}: fractal heap nested too deep")

    # -------------------------------------------------- v2 B-trees
    def v2_btree(self, addr: int) -> list:
        """[(start, end)] of every record of a v2 B-tree, in order."""
        c = self.at(addr)
        c.sig(b"BTHD")
        c.skip(2)
        node_size, rec_size, depth = c.u(4), c.u(2), c.u(2)
        c.skip(2)
        root, root_n = c.addr(), c.u(2)
        if rec_size == 0 or node_size < 10 + rec_size or depth > 16:
            raise ValueError(f"{self.name}: v2 B-tree node {node_size}, "
                             f"record {rec_size}, depth {depth}")
        max_leaf = (node_size - 10) // rec_size
        nrec_size = (max_leaf.bit_length() - 1) // 8 + 1
        cum = [max_leaf]
        cum_size = [0]
        for d in range(1, depth + 1):
            ptr = self.so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            m = (node_size - (10 + ptr)) // (rec_size + ptr)
            cum.append((m + 1) * cum[d - 1] + m)
            cum_size.append((cum[d].bit_length() - 1) // 8 + 1)
        out = []
        seen = set()

        def walk(node, n, d):
            if node in seen or len(out) > self.size:
                raise ValueError(f"{self.name}: a v2 B-tree node repeats")
            seen.add(node)
            c = self.at(node, node_size)
            c.sig(b"BTLF" if d == 0 else b"BTIN")
            c.skip(2)
            recs = []
            for _ in range(n):
                recs.append((c.pos, c.pos + rec_size))
                c.skip(rec_size)
            if d == 0:
                out.extend(recs)
                return
            kids = []
            for _ in range(n + 1):
                ka = c.addr()
                kn = c.u(nrec_size)
                if d > 1:
                    c.u(cum_size[d - 1])
                kids.append((ka, kn))
            for i, (ka, kn) in enumerate(kids):
                walk(ka, kn, d - 1)
                if i < n:
                    out.append(recs[i])

        if root != UNDEF and root_n:
            walk(root, root_n, depth)
        return out

    # -------------------------------------------------- links, attributes
    def link_message(self, c: _Cur):
        if c.u(1) != 1:
            raise ValueError(f"{self.name}: link message version")
        flags = c.u(1)
        ltype = c.u(1) if flags & 0x08 else 0
        order = c.u(8) if flags & 0x04 else None
        if flags & 0x10:
            c.skip(1)
        name = c.take(c.u(1 << (flags & 3))).decode("utf-8")
        kind = {0: "hard", 1: "soft", 64: "external"}.get(ltype)
        if kind is None:
            raise ValueError(f"{self.name}: link type {ltype}")
        return name, (kind, c.addr() if kind == "hard" else None), order

    def links(self, addr: int) -> list:
        """[(name, link)] of a group, in h5py's order."""
        msgs, _ = self.header(addr)
        table = [m for m in msgs if m[0] == 0x11]
        if table:
            c = _Cur(self, table[0][3], table[0][4])
            return self.symbol_table(c.addr(), c.addr())
        info = [m for m in msgs if m[0] == 0x02]
        tracked = False
        found = []
        if info:
            c = _Cur(self, info[0][3], info[0][4])
            c.skip(1)
            flags = c.u(1)
            tracked = bool(flags & 0x01)
            if tracked:
                c.skip(8)
            heap, name_bt = c.addr(), c.addr()
            if heap != UNDEF:
                for start, end in self.v2_btree(name_bt):
                    obj = _Bytes(self, self.heap_object(
                        heap, self.data[start + 4:end]))
                    found.append(obj.link_message(_Cur(obj, 0, obj.size)))
        for m in msgs:
            if m[0] == 0x06:
                found.append(self.link_message(_Cur(self, m[3], m[4])))
        if tracked and all(o is not None for _n, _l, o in found):
            found.sort(key=lambda x: x[2])
        else:
            found.sort(key=lambda x: x[0].encode("utf-8"))
        return [(n, link) for n, link, _o in found]

    def attributes(self, addr: int) -> list:
        """[(name, _Type, shape, reader, start, end)] in h5py's order; the
        value is at [start, end) of ``reader`` (the file, or a dense
        attribute's heap object)."""
        msgs, tracked = self.header(addr)
        found = []
        for mtype, mflags, order, start, end in msgs:
            if mtype == 0x0C:
                if mflags & 0x02:
                    raise ValueError(f"{self.name}: a shared attribute "
                                     f"message is not supported")
                found.append((order, (*self.attribute(start, end), self)))
            elif mtype == 0x15:
                c = _Cur(self, start, end)
                c.skip(1)
                if c.u(1) & 0x01:
                    c.skip(2)
                heap, name_bt = c.addr(), c.addr()
                if heap == UNDEF:
                    continue
                for rs, re_ in self.v2_btree(name_bt):
                    rec = self.data[rs:re_]
                    if len(rec) < 17 or rec[8] & 0x01:
                        raise ValueError(f"{self.name}: a shared or short "
                                         f"dense attribute record")
                    obj = _Bytes(self, self.heap_object(heap, rec[:8]))
                    found.append((int.from_bytes(rec[9:13], "little"),
                                  (*obj.attribute(0, obj.size), obj)))
        if tracked and all(o is not None for o, _a in found):
            found.sort(key=lambda x: x[0])
        else:
            found.sort(key=lambda x: x[1][0].encode("utf-8"))
        return [(n, t, shape, rd, start, end)
                for _o, (n, t, shape, start, end, rd) in found]


class _Bytes(_Reader):
    """A fractal heap object (a link or attribute message) read with the
    file's sizes; its strings live in the file's global heaps."""

    def __init__(self, parent: _Reader, data: bytes):
        self.data, self.size, self.name = data, len(data), parent.name
        self.so, self.sl, self.base = parent.so, parent.sl, 0
        self.file = parent


# ------------------------------------------------------------- tree API
class Attributes:
    """An object's attributes, h5py-style: ``keys()``, ``[name]``,
    ``get``, ``in``; ``info(name)`` gives (type string, shape)."""

    def __init__(self, r: _Reader, addr: int):
        self._items = {a[0]: a[1:] for a in r.attributes(addr)}

    def keys(self):
        return list(self._items)

    def __contains__(self, name):
        return name in self._items

    def __getitem__(self, name):
        t, shape, reader, start, end = self._items[name]
        return reader.values(t, shape, start, end, attr=True)

    def get(self, name, default=None):
        return self[name] if name in self._items else default

    def info(self, name):
        t, shape = self._items[name][:2]
        return t.describe(), ("null" if shape is None else
                              None if shape == () else list(shape))


class _Node:
    def __init__(self, r: _Reader, addr: int, path: str):
        self._r, self._addr, self.name = r, addr, path
        self._attrs = None

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            self._attrs = Attributes(self._r, self._addr)
        return self._attrs


class Group(_Node):
    """A group: ``keys()`` in h5py's order, ``[name]`` (a path with '/'),
    ``in``, ``len``. Soft and external links are listed, not followed."""

    def __init__(self, r, addr, path, root=None):
        super().__init__(r, addr, path)
        self._links = None
        self._root = root or self

    def _table(self) -> dict:
        if self._links is None:
            self._links = dict(self._r.links(self._addr))
        return self._links

    def keys(self):
        return list(self._table())

    def __len__(self):
        return len(self._table())

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self._root if path.startswith("/") else self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group):
                raise KeyError(path)
            link = node._table().get(part)
            if link is None:
                raise KeyError(f"{path!r} is not in {self.name!r}")
            kind, where = link
            child = f"{node.name.rstrip('/')}/{part}"
            if kind != "hard":
                raise ValueError(f"{self._r.name}: {child} is a {kind} link, "
                                 f"which is not followed")
            msgs, _ = self._r.header(where)
            types = {m[0] for m in msgs}
            if 0x08 in types:
                node = Dataset(self._r, where, child)
            else:
                node = Group(self._r, where, child, self._root)
        return node


class Dataset(_Node):
    """A dataset: ``shape``, ``dtype``, ``attrs``, ``[()]`` and
    ``np.asarray`` read it (read-only over the file's bytes)."""

    def __init__(self, r, addr, path):
        super().__init__(r, addr, path)
        msgs, _ = r.header(addr)
        self._msgs = {}
        for m in msgs:
            self._msgs.setdefault(m[0], m)
        for need in (0x01, 0x03, 0x08):
            if need not in self._msgs:
                raise ValueError(f"{r.name}: dataset {path} lacks message "
                                 f"{need:#x}")
        if self._msgs[0x03][1] & 0x02:
            raise ValueError(f"{r.name}: {path} has a committed (shared) "
                             f"datatype, which is not supported")
        m = self._msgs[0x03]
        self._type = r.datatype(_Cur(r, m[3], m[4]))
        m = self._msgs[0x01]
        self.shape = r.dataspace(_Cur(r, m[3], m[4]))
        self.dtype = (np.dtype(object) if self._type.kind == "vlen-str"
                      else self._type.dtype)

    def __array__(self, dtype=None, copy=None):
        a = self[()]
        if isinstance(a, Empty):
            raise TypeError(f"{self.name} has a null dataspace")
        a = np.asarray(a)
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, key):
        a = self._read()
        if isinstance(a, Empty):
            return a
        if key == () or key is Ellipsis:
            return a[()] if a.ndim == 0 else a    # h5py: a numpy scalar
        return a[key]

    def _fill(self) -> bytes:
        r = self._r
        for mtype in (0x05, 0x04):
            if mtype not in self._msgs:
                continue
            _t, _f, _o, start, end = self._msgs[mtype]
            c = _Cur(r, start, end)
            if mtype == 0x04:
                size = c.u(4)
            else:
                version = c.u(1)
                if version in (1, 2):
                    c.skip(2)
                    defined = c.u(1)
                    if version == 2 and not defined:
                        return b""
                elif version == 3:
                    flags = c.u(1)
                    if not flags & 0x20:
                        return b""
                else:
                    raise ValueError(f"{r.name}: fill value version "
                                     f"{version}")
                size = c.u(4)
            return c.take(size) if size == self._type.size else b""
        return b""

    def _filled(self, n):
        fill = self._fill()
        if self._type.kind == "vlen-str":
            one = np.empty(1, dtype=object)
            one[0] = b""
        elif fill:
            one = np.frombuffer(fill, self._type.dtype, 1)
        else:
            one = np.zeros(1, self._type.dtype)
        return np.broadcast_to(one.reshape((1,) * len(self.shape)),
                               self.shape) if self.shape else one[0]

    def _read(self):
        r, t, shape = self._r, self._type, self.shape
        if shape is None:
            return Empty(self.dtype)
        n = r._count(shape)
        _m, _f, _o, start, end = self._msgs[0x08]
        c = _Cur(r, start, end)
        version = c.u(1)
        if version in (1, 2):
            rank, cls = c.u(1), c.u(1)
            c.skip(5)
            addr = c.addr() if cls in (1, 2) else None
            dims = [c.u(4) for _ in range(rank)]
            if cls == 0:
                size = c.u(4)
                return r.values(t, shape, c.pos, c.pos + size, attr=False)
            if cls == 2:
                return self._chunked(addr, dims + [c.u(4)])
        elif version in (3, 4):
            cls = c.u(1)
            if cls == 0:
                size = c.u(2)
                return r.values(t, shape, c.pos, c.pos + size, attr=False)
            if cls == 1:
                addr, size = c.addr(), c.length()
            elif cls == 2 and version == 3:
                ndims = c.u(1)
                addr = c.addr()
                return self._chunked(addr, [c.u(4) for _ in range(ndims)])
            elif cls == 2:            # layout v4: another chunk index
                flags, ndims, enc = c.u(1), c.u(1), c.u(1)
                c.skip(ndims * enc)
                index = c.u(1)
                name = {1: "single chunk", 2: "implicit", 3: "fixed array",
                        4: "extensible array", 5: "v2 B-tree"}.get(
                            index, str(index))
                raise ValueError(f"{r.name}: {self.name} indexes its chunks "
                                 f"by a {name} (layout v4), which is not "
                                 f"supported")
            else:
                raise ValueError(f"{r.name}: layout class {cls}")
        else:
            raise ValueError(f"{r.name}: layout version {version}")
        if addr == UNDEF:
            return self._filled(n)
        if t.kind == "vlen-str":
            p = r.base + addr
            return r.values(t, shape, p, p + n * t.size, attr=False)
        cur = r.at(addr, n * t.size)
        return r.values(t, shape, cur.pos, cur.end, attr=False)

    def _filters(self):
        if 0x0B not in self._msgs:
            return []
        r = self._r
        c = _Cur(r, self._msgs[0x0B][3], self._msgs[0x0B][4])
        version, n = c.u(1), c.u(1)
        if version == 1:
            c.skip(6)
        out = []
        for _ in range(n):
            fid = c.u(2)
            nlen = c.u(2) if version == 1 or fid >= 256 else 0
            flags, nvals = c.u(2), c.u(2)
            c.skip(_pad8(nlen) if version == 1 else nlen)
            vals = [c.u(4) for _ in range(nvals)]
            if version == 1 and nvals % 2:
                c.skip(4)
            out.append((fid, flags, vals))
        return out

    def _chunked(self, addr, dims):
        r, t, shape = self._r, self._type, self.shape
        if t.kind == "vlen-str":
            raise ValueError(f"{r.name}: chunked variable-length strings are "
                             f"not supported")
        rank = len(shape)
        if len(dims) != rank + 1 or dims[-1] != t.size or 0 in dims:
            raise ValueError(f"{r.name}: chunk dims {dims} for shape {shape}")
        chunk = tuple(dims[:rank])
        cbytes = r._count(chunk) * t.size
        nbytes = r._count(shape) * t.size
        if nbytes > MAX_INFLATE * r.size:
            raise ValueError(f"{r.name}: {self.name} declares {nbytes} bytes "
                             f"in a file of {r.size}")
        filters = self._filters()
        if addr == UNDEF:
            return self._filled(r._count(shape))
        key = 8 + 8 * (rank + 1)
        chunks = []
        for k, child in r.v1_btree(addr, 1, key):
            kc = struct.unpack_from(f"<II{rank + 1}Q", k)
            chunks.append((kc[2:2 + rank], kc[0], kc[1], child))
        out = np.empty(shape, t.dtype)
        out[...] = self._filled(r._count(shape))
        for offset, size, mask, caddr in chunks:
            raw = r.at(caddr, size).take(size)
            for i, (fid, _flags, vals) in reversed(list(enumerate(filters))):
                if mask >> i & 1:
                    continue
                raw = _unfilter(r.name, fid, vals, raw, cbytes)
            if len(raw) != cbytes:
                raise ValueError(f"{r.name}: a chunk of {self.name} holds "
                                 f"{len(raw)} bytes, not {cbytes}")
            if any(o % c or o >= s for o, c, s in zip(offset, chunk, shape)):
                raise ValueError(f"{r.name}: chunk offset {offset} of "
                                 f"{self.name}")
            block = np.frombuffer(raw, t.dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offset, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out


def _unfilter(name, fid, vals, raw, limit):
    if fid == 1:
        d = zlib.decompressobj()
        try:
            out = d.decompress(raw, limit + 1)
        except zlib.error as e:
            raise ValueError(f"{name}: a deflated chunk does not inflate: "
                             f"{e}") from None
        return out
    if fid == 2:
        size = vals[0] if vals else 1
        if size <= 1:
            return raw
        n = len(raw) // size
        a = np.frombuffer(raw, np.uint8)
        body = a[:n * size].reshape(size, n).T.reshape(-1)
        return body.tobytes() + raw[n * size:]
    raise ValueError(f"{name}: filter {fid} is not supported (deflate and "
                     f"shuffle are)")


class File(Group):
    """``File(path)`` reads an HDF5 file (all of it, into memory);
    ``File(path, "w")`` returns a ``Writer`` that writes it on ``close``."""

    def __new__(cls, path, mode="r"):
        if mode == "w":
            return Writer(path)
        if mode != "r":
            raise ValueError(f"mode {mode!r}: 'r' or 'w'")
        return super().__new__(cls)

    def __init__(self, path, mode="r"):
        with open(path, "rb") as f:
            data = f.read()
        r = _Reader(data, str(path))
        super().__init__(r, r.root, "/")
        self.filename = str(path)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def describe(path) -> list:
    """The records of ``tests/test_torch_fixtures.h5_describe`` from this
    reader: each group's attributes ([name, type, shape, value]), then its
    members by ``keys()``; datasets with shape, dtype and the sha256 of
    their bytes. ``model_config`` is parsed JSON."""
    out = []

    def value(name, v):
        if isinstance(v, (bytes, np.bytes_)):
            v = v.decode("utf-8")
        if isinstance(v, str):
            return json.loads(v) if name in ("model_config",
                                             "training_config") else v
        if isinstance(v, np.ndarray):
            return ([value(name, x) for x in v.tolist()] if v.ndim
                    else value(name, v[()]))
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, list):
            return [value(name, x) for x in v]
        return None if isinstance(v, Empty) else v

    def walk(path, node):
        attrs = [[k, *node.attrs.info(k), value(k, node.attrs[k])]
                 for k in node.attrs.keys()]
        if isinstance(node, Dataset):
            v = node[()]
            if isinstance(v, Empty):
                shape, dtype, sha = "null", v.dtype.str, None
            else:
                a = np.asarray(v)
                if a.dtype == object:         # variable-length strings
                    a = np.array([bytes(x) for x in a.reshape(-1)]).reshape(
                        a.shape)
                shape, dtype = list(a.shape), a.dtype.str
                sha = hashlib.sha256(
                    np.ascontiguousarray(a).tobytes()).hexdigest()
            out.append({"path": path, "kind": "dataset", "shape": shape,
                        "dtype": dtype, "sha256": sha, "attrs": attrs})
            return
        out.append({"path": path, "kind": "group", "attrs": attrs})
        for k in node.keys():
            walk(f"{path.rstrip('/')}/{k}", node[k])

    with File(path) as f:
        walk("/", f)
    return out


# ------------------------------------------------------------------ writer
def _value_type(v):
    """(kind, payload, shape) of an attribute value, typed as h5py types
    the same Python value: str -> variable-length UTF-8, bytes ->
    variable-length ASCII, lists of either -> arrays of them, ``np.bytes_``
    and 'S' arrays -> fixed-length null-padded ASCII, [] -> float64 (0,),
    numbers -> their numpy type."""
    if isinstance(v, str):
        return ("vlen", 1, [v.encode("utf-8")], ())
    if isinstance(v, np.bytes_):
        return ("fixed", np.array(v), ())
    if isinstance(v, bytes):
        return ("vlen", 0, [v], ())
    if isinstance(v, (list, tuple)) and v and all(
            isinstance(x, (str, bytes)) for x in v):
        if all(isinstance(x, str) for x in v):
            return ("vlen", 1, [x.encode("utf-8") for x in v], (len(v),))
        if all(isinstance(x, bytes) for x in v):
            return ("vlen", 0, list(v), (len(v),))
        raise ValueError("an attribute list mixes str and bytes")
    a = np.asarray(v)
    if a.dtype.kind == "S":
        return ("fixed", a, a.shape)
    if a.dtype.kind == "O" and a.size:
        items = a.reshape(-1).tolist()
        if all(isinstance(x, str) for x in items):
            return ("vlen", 1, [x.encode("utf-8") for x in items], a.shape)
        if all(isinstance(x, bytes) for x in items):
            return ("vlen", 0, items, a.shape)
    if not _numeric(a.dtype):
        raise ValueError(f"an attribute of dtype {a.dtype} is not supported")
    return ("num", a, a.shape)


def _numeric(dt: np.dtype) -> bool:
    """A dtype the writer stores: integers of 1-8 bytes, float32/64."""
    return ((dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8))
            or (dt.kind == "f" and dt.itemsize in (4, 8)))


def _enc_numeric(dt: np.dtype) -> bytes:
    big = dt.byteorder == ">" or (dt.byteorder == "=" and
                                  np.little_endian is False)
    size = dt.itemsize
    if dt.kind in "iu":
        bits = (0x08 if dt.kind == "i" else 0) | int(big)
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, size * 8))
    exp = {4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
    eloc, esize, msize, bias = exp[size]
    return (bytes([0x11, 0x20 | int(big), size * 8 - 1, 0])
            + struct.pack("<I", size)
            + struct.pack("<HHBBBBI", 0, size * 8, eloc, esize, 0, msize,
                          bias))


def _enc_string(size: int, cset: int, pad: int = 1) -> bytes:
    return bytes([0x13, pad | cset << 4, 0, 0]) + struct.pack("<I", size)


def _enc_vlen_string(cset: int) -> bytes:
    return (bytes([0x19, 0x01, cset, 0]) + struct.pack("<I", 16)
            + bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8))


def _enc_space(shape) -> bytes:
    rank = len(shape)
    out = struct.pack("<BBBB4x", 1, rank, 1 if rank else 0, 0)
    if rank:
        out += struct.pack(f"<{rank}Q", *shape) * 2
    return out


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    if len(body) > 0xFFFF - 7:
        raise ValueError(f"an object header message of {len(body)} bytes "
                         f"does not fit a v1 object header (64 KiB)")
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _p8(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


class _WAttrs(dict):
    """Attributes of an object being written: a dict, name -> value."""


class _WNode:
    def __init__(self):
        self.attrs = _WAttrs()


class _WDataset(_WNode):
    def __init__(self, data):
        super().__init__()
        self.data = data
        self.shape, self.dtype = data.shape, data.dtype


class _WGroup(_WNode):
    def __init__(self):
        super().__init__()
        self.members: dict = {}

    def _parent_of(self, path: str, create: bool):
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"an empty name {path!r}")
        node = self
        for p in parts[:-1]:
            nxt = node.members.get(p)
            if nxt is None:
                if not create:
                    raise KeyError(path)
                nxt = node.members[p] = _WGroup()
            if not isinstance(nxt, _WGroup):
                raise ValueError(f"{p} in {path!r} is a dataset")
            node = nxt
        return node, parts[-1]

    def create_group(self, path: str) -> "_WGroup":
        parent, name = self._parent_of(path, True)
        if name in parent.members:
            raise ValueError(f"{path!r} already exists")
        g = parent.members[name] = _WGroup()
        return g

    def create_dataset(self, path: str, shape=None, dtype=None, data=None):
        parent, name = self._parent_of(path, True)
        if name in parent.members:
            raise ValueError(f"{path!r} already exists")
        if data is None:
            data = np.zeros(shape, dtype or np.float32)
        a = np.array(data, dtype=dtype, order="C")
        if not (_numeric(a.dtype) or a.dtype.kind == "S"):
            raise ValueError(f"a dataset of dtype {a.dtype} is not supported")
        d = parent.members[name] = _WDataset(a)
        return d

    def __getitem__(self, path):
        parent, name = self._parent_of(path, False)
        return parent.members[name]

    def keys(self):
        return sorted(self.members, key=lambda n: n.encode("utf-8"))


class Writer(_WGroup):
    """The root of a file being written; ``close()`` (or leaving a
    ``with`` block) writes it."""

    def __init__(self, path):
        super().__init__()
        self.path = str(path)
        self._closed = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()

    def close(self):
        if not self._closed:
            data = _Serializer(self).run()
            with open(self.path, "wb") as f:
                for piece in data:
                    f.write(piece)
            self._closed = True


class _Serializer:
    """Lays a written tree out: superblock, global heap collections, then
    each object after its members (raw data, heaps, SNODs, B-tree nodes,
    its header), the root last."""

    SUPERBLOCK = 96

    def __init__(self, root: _WGroup):
        self.root = root
        self.pieces: list = []
        self.pos = 0
        self.vlen_ids: dict = {}   # id(list of encoded strings) -> heap IDs

    def put(self, b) -> int:
        at = self.pos
        self.pieces.append(b)
        self.pos += len(b)
        pad = _pad8(self.pos) - self.pos
        if pad:
            self.pieces.append(b"\0" * pad)
            self.pos += pad
        return at

    def run(self) -> list:
        self.put(b"\0" * self.SUPERBLOCK)
        strings = []
        self._collect(self.root, strings)
        self._global_heaps(strings)
        root_hdr, btree, heap = self._group(self.root)
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, self.pos, UNDEF)
              + struct.pack("<QQII", 0, root_hdr, 1, 0)
              + struct.pack("<QQ", btree, heap))
        assert len(sb) == self.SUPERBLOCK
        self.pieces[0] = sb
        return self.pieces

    # ---------------------------------------------------- strings
    def _collect(self, node, strings):
        for name in sorted(node.attrs):
            typed = _value_type(node.attrs[name])
            if typed[0] == "vlen":
                strings.append(typed[2])
            node.attrs[name] = (node.attrs[name], typed)
        if isinstance(node, _WGroup):
            for k in node.keys():
                self._collect(node.members[k], strings)

    def _global_heaps(self, strings):
        """One collection per 65,535 strings; each string's heap ID."""
        flat = [s for group in strings for s in group]
        ids = []
        for c0 in range(0, len(flat), 65535):
            objs = flat[c0:c0 + 65535]
            body = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(s)) + _p8(s)
                            for i, s in enumerate(objs))
            used = 16 + len(body)
            size = max(4096, used + 16)
            free = struct.pack("<HH4xQ", 0, 0, size - used)
            gcol = (b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size)
                    + body + free + b"\0" * (size - used - 16))
            at = self.put(gcol)
            ids.extend((at, i + 1) for i in range(len(objs)))
        it = iter(ids)
        for group in strings:
            self.vlen_ids[id(group)] = [next(it) for _ in group]

    # ---------------------------------------------------- messages
    def _attr_messages(self, node) -> list:
        msgs = []
        for name in sorted(node.attrs):
            _v, typed = node.attrs[name]
            if typed[0] == "vlen":
                _k, cset, items, shape = typed
                tb = _enc_vlen_string(cset)
                data = b"".join(struct.pack("<IQI", len(s), *hid)
                                for s, hid in zip(items,
                                                  self.vlen_ids[id(items)]))
            elif typed[0] == "fixed":
                a = typed[1]
                tb = _enc_string(max(a.dtype.itemsize, 1), 0)
                shape = typed[2]
                data = a.astype(f"S{max(a.dtype.itemsize, 1)}").tobytes()
            else:
                a, shape = typed[1], typed[2]
                tb = _enc_numeric(a.dtype)
                data = np.ascontiguousarray(a).tobytes()
            sb = _enc_space(shape)
            nb = name.encode("utf-8") + b"\0"
            body = (struct.pack("<BBHHH", 1, 0, len(nb), len(tb), len(sb))
                    + _p8(nb) + _p8(tb) + _p8(sb) + data)
            msgs.append(_message(0x0C, body))
        return msgs

    def _header(self, msgs: list) -> int:
        chunk = b"".join(msgs)
        return self.put(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                    len(chunk)) + chunk)

    def _dataset(self, d: _WDataset) -> int:
        a = d.data
        nbytes = a.nbytes
        addr = self.put(a.tobytes()) if nbytes else UNDEF
        if a.dtype.kind == "S":
            tb = _enc_string(a.dtype.itemsize, 0)
        else:
            tb = _enc_numeric(a.dtype)
        msgs = [_message(0x01, _enc_space(a.shape)),
                _message(0x03, tb, flags=1),
                _message(0x05, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
                _message(0x08, struct.pack("<BBQQ", 3, 1, addr, nbytes))]
        return self._header(msgs + self._attr_messages(d))

    # ---------------------------------------------------- groups
    def _group(self, g: _WGroup):
        """(header address, B-tree address, heap address) of ``g``."""
        entries = []
        for name in g.keys():
            child = g.members[name]
            if isinstance(child, _WGroup):
                hdr, bt, hp = self._group(child)
                entries.append((name, hdr, 1, struct.pack("<QQ", bt, hp)))
            else:
                entries.append((name, self._dataset(child), 0, b"\0" * 16))
        heap_data, offsets = bytearray(b"\0" * 8), []
        for name, *_ in entries:
            offsets.append(len(heap_data))
            heap_data += _p8(name.encode("utf-8") + b"\0")
        heap = self.pos
        self.put(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data),
                                                  _FREE_NULL, heap + 32)
                 + bytes(heap_data))
        snod_size = 8 + 2 * _LEAF_K * 40
        children = []             # (address, largest name's heap offset)
        for s in range(0, len(entries), 2 * _LEAF_K):
            part = entries[s:s + 2 * _LEAF_K]
            body = b"".join(
                struct.pack("<QQII", offsets[s + i], hdr, cache, 0) + scratch
                for i, (_n, hdr, cache, scratch) in enumerate(part))
            at = self.put(b"SNOD" + struct.pack("<BBH", 1, 0, len(part))
                          + body + b"\0" * (snod_size - 8 - len(body)))
            children.append((at, offsets[s + len(part) - 1]))
        btree = self._btree(children)
        hdr = self._header([_message(0x11, struct.pack("<QQ", btree, heap))]
                           + self._attr_messages(g))
        return hdr, btree, heap

    def _btree(self, children: list) -> int:
        """Group B-tree nodes (2 x internal K children each) over the SNODs,
        level by level up to one root; returns the root's address."""
        fan = 2 * _INTERNAL_K
        node_size = 24 + (fan + 1) * 8 + fan * 8
        level = 0
        while True:
            groups = [children[i:i + fan]
                      for i in range(0, len(children), fan)] or [[]]
            first = self.pos
            addrs = [first + i * node_size for i in range(len(groups))]
            nxt, left_key = [], 0
            for i, part in enumerate(groups):
                left = addrs[i - 1] if i else UNDEF
                right = addrs[i + 1] if i + 1 < len(groups) else UNDEF
                body = struct.pack("<Q", left_key)
                for child, key in part:
                    body += struct.pack("<QQ", child, key)
                node = (b"TREE" + struct.pack("<BBHQQ", 0, level, len(part),
                                              left, right) + body)
                at = self.put(node + b"\0" * (node_size - len(node)))
                assert at == addrs[i]
                if part:
                    left_key = part[-1][1]
                nxt.append((at, left_key))
            if len(groups) == 1:
                return addrs[0]
            children, level = nxt, level + 1
