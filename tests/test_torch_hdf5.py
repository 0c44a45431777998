"""The port's HDF5 codec (``tpusr_torch/train/hdf5.py``) against h5py.

The reader is held to h5py's view of files that h5py writes here (both
``libver`` bounds; every string, number, dataspace, layout, filter and
group size the codec claims), record for record (``h5_describe`` against
``hdf5.describe``: the tree in order, each attribute's type, shape and
value, each dataset's shape, dtype and sha256). The writer is held to h5py
reading its files back, with the datatypes asked for, and to the reader;
a hypothesis test does both over random trees. Truncated and crafted files
must raise ``ValueError`` without sizing memory from a crafted field.
"""

import struct
import tracemalloc

import h5py
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from test_torch_fixtures import h5_describe
from tpusr_torch.train import hdf5

LIBVERS = ("earliest", "latest")


def same_as_h5py(path):
    assert hdf5.describe(path) == h5_describe(path)


def write_compact(f, name, data):
    """A dataset with the compact layout (h5py's high level has no knob)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    sid = h5py.h5s.create_simple(data.shape)
    tid = h5py.h5t.py_create(data.dtype)
    dsid = h5py.h5d.create(f.id, name.encode(), tid, sid, dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


# ------------------------------------------------------------- the reader
@pytest.mark.parametrize("libver", LIBVERS)
def test_strings_and_attribute_spaces_read_as_h5py(tmp_path, libver):
    p = tmp_path / "s.h5"
    with h5py.File(p, "w", libver=libver) as f:
        f.attrs["vlen_ascii"] = b"tensorflow"
        f.attrs["vlen_utf8"] = "grüße ✓"
        f.attrs["vlen_ascii_list"] = [b"conv1", b"conv2", b"a" * 300]
        f.attrs["vlen_utf8_list"] = ["é", "b", ""]
        f.attrs["fixed_nullpad"] = np.array([b"ab", b"cde"])
        f.attrs["fixed_scalar"] = np.bytes_(b"abc")
        f.attrs.create("fixed_nullterm", np.array([b"xy", b"z"]),
                       dtype=h5py.string_dtype("ascii", 3))
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(4)
        tid.set_strpad(h5py.h5t.STR_NULLTERM)
        tid.set_cset(h5py.h5t.CSET_UTF8)
        aid = h5py.h5a.create(f.id, b"fixed_utf8_nullterm", tid,
                              h5py.h5s.create(h5py.h5s.SCALAR))
        aid.write(np.array(b"\xc3\xa9a", dtype="S4"), mtype=tid)
        f.attrs["empty_list"] = []
        f.attrs["null"] = h5py.Empty("f4")
        f.attrs["zero_i8"] = np.zeros((0, 3), np.int8)
        f.attrs["f64"] = 1.5
        f.attrs["i64"] = -7
        f.attrs["u16_array"] = np.arange(5, dtype=np.uint16)
        f.attrs["f32_be"] = np.array([1.25, -2.0], ">f4")
        f.attrs["matrix"] = np.arange(6, dtype=np.float64).reshape(2, 3)
    same_as_h5py(p)
    with hdf5.File(p) as r:
        a = r.attrs
        assert a["vlen_ascii"] == "tensorflow"
        assert a["vlen_utf8_list"].tolist() == ["é", "b", ""]
        assert a["fixed_nullpad"].dtype == np.dtype("S3")
        assert isinstance(a["null"], hdf5.Empty)
        assert a["empty_list"].shape == (0,)
        assert a.info("vlen_ascii") == ("vlen-str/ascii", None)
        assert a.info("null") == ("<f4", "null")


@pytest.mark.parametrize("libver", LIBVERS)
def test_dtypes_and_layouts_read_as_h5py(tmp_path, libver):
    rng = np.random.default_rng(0)
    p = tmp_path / "d.h5"
    with h5py.File(p, "w", libver=libver) as f:
        for dt in ("<f4", "<f8", ">f4", ">f8", "i1", "<i2", ">i4",
                   "<i8", "u1", "<u2", "<u4", ">u8"):
            f.create_dataset(f"contig_{dt}",
                             data=(rng.standard_normal((3, 5)) * 50).astype(dt))
        f.create_dataset("scalar", data=np.float32(3.5))
        f.create_dataset("empty", data=np.zeros((0, 4), np.float32))
        f.create_dataset("fixed_strings", data=np.array([b"ab", b"c"]))
        f.create_dataset("unwritten", shape=(4, 3), dtype="f4")
        f.create_dataset("unwritten_fill", shape=(2, 2), dtype="f8",
                         fillvalue=2.5)
        f.create_dataset("null", data=h5py.Empty("f4"))
        write_compact(f, "compact", np.arange(12, dtype=np.int32).reshape(3, 4))
        f.create_dataset("vlen", data=np.array([b"one", b"three"], object),
                         dtype=h5py.string_dtype("ascii"))
        d = f.create_dataset("with_attrs", data=np.ones(2))
        d.attrs["note"] = "a dataset attribute"
    same_as_h5py(p)


def test_chunked_layouts_read_as_h5py(tmp_path):
    rng = np.random.default_rng(1)
    big = rng.standard_normal((37, 23, 5)).astype(np.float32)
    p = tmp_path / "c.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("plain", data=big, chunks=(8, 8, 5))
        f.create_dataset("gzip", data=big, chunks=(10, 7, 2),
                         compression="gzip", compression_opts=9)
        f.create_dataset("shuffle_gzip", data=big, chunks=(16, 16, 5),
                         shuffle=True, compression="gzip")
        f.create_dataset("one_chunk", data=big, chunks=(37, 23, 5),
                         shuffle=True, compression="gzip")
        f.create_dataset("ints", data=np.arange(1000, dtype=">i8"),
                         chunks=(64,), compression="gzip")
        f.create_dataset("unwritten", shape=(100, 3), chunks=(10, 3),
                         dtype="f4", fillvalue=-1.0, compression="gzip")
        part = f.create_dataset("partial", shape=(40, 40), chunks=(16, 16),
                                dtype="f8", fillvalue=7.0,
                                compression="gzip")
        part[3:20, 30:40] = 1.5
        f.create_dataset("deep", data=np.arange(5000, dtype=np.float32),
                         chunks=(4,))  # 1250 chunks: a B-tree of depth 2
    same_as_h5py(p)


def test_layout_v4_chunk_indexes_raise_naming_themselves(tmp_path):
    """libver latest indexes chunks by layout v4 (Keras never chunks):
    each index raises ValueError naming itself (ROADMAP queue 3); the
    fletcher32 filter, which the codec does not take, names itself too."""
    a = np.arange(60, dtype=np.float32).reshape(6, 10)
    p = tmp_path / "v4.h5"
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("single", data=a, chunks=(6, 10), compression="gzip")
        f.create_dataset("fixed_array", data=a, chunks=(2, 5))
    q = tmp_path / "f32.h5"
    with h5py.File(q, "w") as f:
        f.create_dataset("fletcher", data=a, chunks=(3, 5), fletcher32=True)
    with hdf5.File(p) as r:
        for name, index in (("single", "single chunk"),
                            ("fixed_array", "fixed array")):
            with pytest.raises(ValueError, match=index):
                r[name][()]
    with hdf5.File(q) as r, pytest.raises(ValueError, match="filter 3"):
        r["fletcher"][()]


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("members", [1, 8, 9, 256, 257, 1000])
def test_group_sizes_read_as_h5py(tmp_path, libver, members):
    p = tmp_path / "g.h5"
    rng = np.random.default_rng(members)
    with h5py.File(p, "w", libver=libver) as f:
        g = f.create_group("model_weights")
        for i in rng.permutation(members):
            if i % 3:
                g.create_group(f"layer_{i}").attrs["weight_names"] = []
            else:
                g.create_dataset(f"w{i:04d}", data=np.full(2, i, np.float32))
    same_as_h5py(p)
    with hdf5.File(p) as r:
        assert len(r["model_weights"]) == members


def test_creation_order_reads_as_h5py_and_soft_links_are_listed(tmp_path):
    p = tmp_path / "o.h5"
    with h5py.File(p, "w", libver="latest", track_order=True) as f:
        g = f.create_group("ordered", track_order=True)
        for name in ("zeta", "alpha", "mid") + tuple(f"n{i}" for i in range(12)):
            g.create_group(name)
        for name in ("b", "a", "c"):
            g.attrs[name] = name
        f["ordered/zeta"].create_dataset("x", data=np.arange(3))
    same_as_h5py(p)
    with h5py.File(p, "a") as f:
        f["link"] = h5py.SoftLink("/ordered/zeta")
    with hdf5.File(p) as r:
        assert r["ordered"].keys()[:3] == ["zeta", "alpha", "mid"]
        assert r["ordered"].attrs.keys() == ["b", "a", "c"]
        assert "link" in r.keys()
        with pytest.raises(ValueError, match="soft link"):
            r["link"]


@pytest.mark.parametrize("libver", LIBVERS)
def test_attributes_over_64k_read_as_h5py(tmp_path, libver):
    """Over 64 KiB an attribute is a variable-length string in the global
    heap (earliest), or, under latest, a fixed-size one in dense storage (a
    huge fractal-heap object; more than 8 attributes go dense too)."""
    p = tmp_path / "big.h5"
    config = "{" + ", ".join(f'"k{i}": {i}' for i in range(12000)) + "}"
    assert len(config) > 65536
    with h5py.File(p, "w", libver=libver) as f:
        f.attrs["model_config"] = config.encode("utf8")
        if libver == "latest":
            f.attrs["big_array"] = np.arange(20000, dtype=np.float64)
            g = f.create_group("many")
            for i in range(20):
                g.attrs[f"a{i:02d}"] = np.arange(i + 1, dtype=np.int32)
            g.attrs["text"] = "x" * 5000
    same_as_h5py(p)


# ------------------------------------------------------------- the writer
def writer_tree(path, members=(1, 8, 9, 256, 257, 1000)):
    rng = np.random.default_rng(3)
    with hdf5.File(path, "w") as f:
        f.attrs["backend"] = "tensorflow"
        f.attrs["keras_version"] = "3.13.1"
        f.attrs["model_config"] = ('{"class_name": "Sequential", "k": '
                                   + '"' + "y" * 70000 + '"}').encode("utf8")
        f.attrs["fixed"] = np.array([b"ab", b"cde"])
        f.attrs["fixed_scalar"] = np.bytes_(b"xyz")
        f.attrs["ints"] = np.arange(3, dtype=np.int64)
        f.attrs["f64"] = 0.25
        for n in members:
            g = f.create_group(f"group_{n}")
            g.attrs["layer_names"] = [f"l{i}".encode() for i in range(n)]
            for i in range(n):
                if i % 2:
                    g.create_group(f"l{i}").attrs["weight_names"] = []
                else:
                    g.create_dataset(f"l{i}", data=np.full(3, i, np.float32))
        f.create_dataset("deep/a/b/kernel",
                         data=rng.standard_normal((3, 3, 4, 5)).astype("<f4"))
        f.create_dataset("be", data=np.arange(4, dtype=">f8"))
        f.create_dataset("i16", data=np.arange(-3, 3, dtype=np.int16))
        f.create_dataset("scalar", data=np.float32(2.0))
        f.create_dataset("empty", data=np.zeros((0,), np.float32))
        f.create_dataset("names", data=np.array([b"a", b"bc"]))
        f["deep/a"].attrs["weight_names"] = ["a/b/kernel"]


def test_writer_reads_back_in_h5py_with_the_types_asked(tmp_path):
    p = tmp_path / "w.h5"
    writer_tree(p)
    recs = h5_describe(p)
    assert hdf5.describe(p) == recs
    root = {r[0]: r[1:3] for r in recs[0]["attrs"]}
    assert root == {"backend": ["vlen-str/utf8", None],
                    "keras_version": ["vlen-str/utf8", None],
                    "model_config": ["vlen-str/ascii", None],
                    "fixed": ["str3/nullpad/ascii", [2]],
                    "fixed_scalar": ["str3/nullpad/ascii", None],
                    "ints": ["<i8", [3]], "f64": ["<f8", None]}
    with h5py.File(p, "r") as f:
        assert f.libver[0] == "earliest"
        assert f.id.get_create_plist().get_version()[0] == 0
        for n in (1, 8, 9, 256, 257, 1000):
            g = f[f"group_{n}"]
            assert len(g) == n
            assert [x.decode() if isinstance(x, bytes) else x
                    for x in g.attrs["layer_names"]] == [f"l{i}" for i in range(n)]
            assert g[f"l{n - 1 - (n - 1) % 2}"][1] == n - 1 - (n - 1) % 2
        assert f["deep/a/b/kernel"].dtype == np.dtype("<f4")
        assert f["be"].dtype == np.dtype(">f8")
        assert f["scalar"][()] == np.float32(2.0)
        assert f["empty"].shape == (0,)
        assert f.attrs["model_config"].startswith('{"class_name"')


def test_writer_group_btree_reaches_depth_two(tmp_path):
    """Over 256 members a group's B-tree has a second level (8 entries an
    SNOD, 32 children a node); h5py looks every member up through it."""
    p = tmp_path / "deep.h5"
    names = [f"m{i:05d}" for i in range(1500)]
    with hdf5.File(p, "w") as f:
        for n in names:
            f.create_group(n)
    with h5py.File(p, "r") as f:
        assert list(f.keys()) == names
        assert all(n in f for n in names[::97])
    with open(p, "rb") as fh:
        fh.seek(_root_btree(p))
        head = fh.read(6)
    assert head[:4] == b"TREE" and head[5] == 1   # the root's level


def _root_header(path):
    with open(path, "rb") as fh:
        sb = fh.read(96)
    return struct.unpack_from("<Q", sb, 64)[0]


def _root_btree(path):
    with open(path, "rb") as fh:
        sb = fh.read(96)
    return struct.unpack_from("<Q", sb, 80)[0]


names_st = st.text(alphabet="abcdefghijklmnopqrstuvwxyz_0123456789",
                   min_size=1, max_size=12)
# UTF-8 text: a lone surrogate is not encodable, and h5py refuses it as the
# writer does (test_writer_refuses_a_lone_surrogate_as_h5py)
values_st = st.one_of(
    st.text(alphabet=st.characters(min_codepoint=1,
                                   exclude_categories=("Cs",)), max_size=30),
    st.text(alphabet=st.characters(min_codepoint=1, max_codepoint=127),
            max_size=30).map(str.encode),
    st.lists(names_st.map(str.encode), min_size=1, max_size=5),
    st.integers(-2 ** 40, 2 ** 40), st.floats(allow_nan=False, width=64),
    st.lists(st.floats(allow_nan=False, width=32), max_size=6).map(
        lambda v: np.asarray(v, np.float32)))


@st.composite
def trees(draw, depth=0):
    node = {"attrs": draw(st.dictionaries(names_st, values_st, max_size=3)),
            "members": {}}
    for name in draw(st.lists(names_st, max_size=6 if depth < 2 else 0,
                              unique=True)):
        if draw(st.booleans()) and depth < 2:
            node["members"][name] = draw(trees(depth + 1))
        else:
            shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
            dt = draw(st.sampled_from(["<f4", ">f8", "<i2", "u1"]))
            node["members"][name] = np.arange(int(np.prod(shape)),
                                              dtype=dt).reshape(shape)
    return node


def _write(g, node):
    for k, v in node["attrs"].items():
        g.attrs[k] = v
    for k, v in node["members"].items():
        if isinstance(v, dict):
            _write(g.create_group(k), v)
        else:
            g.create_dataset(k, data=v)


@settings(max_examples=25, deadline=None)
@given(tree=trees())
def test_writer_random_trees_round_trip(tmp_path_factory, tree):
    p = tmp_path_factory.mktemp("h") / "r.h5"
    with hdf5.File(p, "w") as f:
        _write(f, tree)
    recs = h5_describe(p)
    assert hdf5.describe(p) == recs

    def check(g, node):
        for k, v in node["attrs"].items():
            got = g.attrs[k]
            if isinstance(v, (str, bytes)):
                assert got == (v.decode() if isinstance(v, bytes) else v)
            elif isinstance(v, list):
                assert [x.decode() if isinstance(x, bytes) else x
                        for x in got] == [x.decode() for x in v]
            else:
                np.testing.assert_array_equal(got, v)
        for k, v in node["members"].items():
            if isinstance(v, dict):
                check(g[k], v)
            else:
                assert g[k].dtype == v.dtype and g[k].shape == v.shape
                np.testing.assert_array_equal(g[k][()], v)

    with h5py.File(p, "r") as f:
        check(f, tree)


# ------------------------------------------------------------- bad files
def test_writer_refuses_a_lone_surrogate_as_h5py(tmp_path):
    """A string attribute is stored as UTF-8; one with a lone surrogate has
    no UTF-8 form, and the writer raises h5py's error for it."""
    with h5py.File(tmp_path / "h.h5", "w") as f:
        with pytest.raises(UnicodeEncodeError):
            f.attrs["a"] = "\ud800"
    with pytest.raises(UnicodeEncodeError):
        with hdf5.File(tmp_path / "p.h5", "w") as f:
            f.attrs["a"] = "\ud800"


def test_truncated_files_raise_value_error(tmp_path):
    p = tmp_path / "w.h5"
    writer_tree(p, members=(9, 300))
    data = p.read_bytes()
    q = tmp_path / "cut.h5"
    for cut in (0, 7, 95, 400, len(data) // 3, len(data) // 2, len(data) - 1):
        q.write_bytes(data[:cut])
        with pytest.raises(ValueError):
            hdf5.describe(q)


def _peak_mib(fn):
    tracemalloc.start()
    try:
        fn()
    finally:
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
    return peak / 2 ** 20


def test_crafted_headers_raise_value_error_without_sizing_memory(tmp_path):
    p = tmp_path / "ok.h5"
    with hdf5.File(p, "w") as f:
        f.create_dataset("x", data=np.arange(4, dtype=np.float32))
        f.attrs["s"] = "abc"
    data = bytearray(p.read_bytes())
    shape_at = data.index(struct.pack("<BBBB4xQQ", 1, 1, 1, 0, 4, 4))
    gcol = data.index(b"GCOL")
    cases = {
        # the dataset claims 2^40 elements of its 16 bytes
        "dims": (shape_at + 8, struct.pack("<QQ", 1 << 40, 1 << 40)),
        # the global heap claims 2^50 bytes
        "gheap": (gcol + 8, struct.pack("<Q", 1 << 50)),
        # the SNOD claims 60000 entries
        "snod": (data.index(b"SNOD") + 6, struct.pack("<H", 60000)),
        # the root B-tree's first child points at the node itself
        "loop": (_root_btree(p) + 32, struct.pack("<Q", _root_btree(p))),
        # the root object header claims a chunk of 1 GiB
        "header": (_root_header(p) + 8, struct.pack("<I", 1 << 30)),
    }
    for name, (at, patch) in cases.items():
        bad = bytearray(data)
        bad[at:at + len(patch)] = patch
        q = tmp_path / f"{name}.h5"
        q.write_bytes(bytes(bad))

        def read():
            with pytest.raises(ValueError):
                hdf5.describe(q)
        assert _peak_mib(read) < 16, name


def test_random_corruption_raises_only_value_error(tmp_path):
    p = tmp_path / "w.h5"
    writer_tree(p, members=(9,))
    data = p.read_bytes()
    rng = np.random.default_rng(7)
    q = tmp_path / "bad.h5"
    for _ in range(150):
        bad = bytearray(data)
        for at in rng.integers(96, len(data), 4):
            bad[at] = rng.integers(0, 256)
        q.write_bytes(bytes(bad))

        def read():
            try:
                hdf5.describe(q)
            except ValueError:
                pass
        assert _peak_mib(read) < 64
