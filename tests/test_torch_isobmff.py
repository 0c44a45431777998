"""The port's MP4/QuickTime demuxer (``tpusr_torch/data/isobmff.py``)
against ``cv2.VideoCapture`` (FFmpeg's ``mov`` demuxer) on the CPU, on
files rewritten here box by box from a clip that ``cv2.VideoWriter``
wrote (``tests/data/mpeg4/pan_96x64.mp4``):

- ``moov`` before and after ``mdat`` (the chunk offsets patched), ``co64``
  in place of ``stco``, a ``mdat`` with a 64-bit ``largesize``: the same
  frames as cv2's;
- the rate ``CAP_PROP_FPS`` gives at 10, 25, 29.97 (30000/1001) and 30
  fps, set through the media timescale and the sample durations;
- each refusal by name: H.264, HEVC, VP9 and AV1 sample entries, ``ctts``,
  ``moof``, Matroska, an offset past the end of the file, no video track,
  an edit list other than cv2's, variable durations.
"""

import os
import struct

import numpy as np
import pytest

from test_torch_mpeg4 import FIXTURES, fx
from tpusr_torch.data import isobmff
from tpusr_torch.data.video import open_video

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}
CLIP = os.path.join(FIXTURES, "pan_96x64.mp4")


def parse(data: bytes) -> list:
    """The box tree: [type, children (a list) or payload (bytes)]."""
    out = []
    for kind, start, end in isobmff.boxes(data, 0, len(data), "t"):
        body = data[start:end]
        out.append([kind, parse(body) if kind in CONTAINERS else body])
    return out


def serialize(tree: list, large: set = frozenset()) -> bytes:
    out = b""
    for kind, body in tree:
        payload = serialize(body, large) if isinstance(body, list) else body
        if kind in large:
            out += struct.pack(">I4sQ", 1, kind, len(payload) + 16) + payload
        else:
            out += struct.pack(">I4s", len(payload) + 8, kind) + payload
    return out


def find(tree: list, *path: bytes) -> list:
    node = tree
    for kind in path:
        node = next(b for b in (node if isinstance(node, list) and node and
                                isinstance(node[0], list) else node[1])
                    if b[0] == kind)
    return node


def stbl(tree):
    return find(tree, b"moov", b"trak", b"mdia", b"minf", b"stbl")


def set_offsets(tree: list, offsets, wide: bool = False) -> None:
    """Rewrite the chunk offset box (as ``co64`` when ``wide``)."""
    table = stbl(tree)[1]
    i = next(k for k, b in enumerate(table) if b[0] in (b"stco", b"co64"))
    fmt = ">Q" if wide else ">I"
    table[i] = [b"co64" if wide else b"stco",
                struct.pack(">II", 0, len(offsets))
                + b"".join(struct.pack(fmt, o) for o in offsets)]


def chunk_offsets(tree: list) -> list:
    box = next(b for b in stbl(tree)[1] if b[0] in (b"stco", b"co64"))
    n = struct.unpack(">I", box[1][4:8])[0]
    fmt = ">Q" if box[0] == b"co64" else ">I"
    size = struct.calcsize(fmt)
    return [struct.unpack(fmt, box[1][8 + size * k: 8 + size * (k + 1)])[0]
            for k in range(n)]


def relaid(tree: list, order: list, wide=False, large=frozenset()) -> bytes:
    """The file with its top-level boxes in ``order``, the chunk offsets
    moved with ``mdat``."""
    old = serialize(tree)
    mdat_at = old.index(serialize([find(tree, b"mdat")])) + 8
    rel = [o - mdat_at for o in chunk_offsets(tree)]
    top = [find(tree, k) for k in order]
    head = 16 if b"mdat" in large else 8
    for _ in range(2):                    # the offsets' width may move mdat
        data = serialize(top, large)
        new_at = data.index(serialize([find(tree, b"mdat")], large)) + head
        set_offsets(top, [new_at + r for r in rel], wide)
    return serialize(top, large)


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _equal_to_cv2(path):
    want, fps = fx.read_cv2(path)
    video = open_video(path)
    got = [f() for f in video.frames()]
    assert video.fps == fps and len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return video


def _tree():
    with open(CLIP, "rb") as f:
        return parse(f.read())


@pytest.mark.parametrize("layout", ["as_written", "moov_first", "co64",
                                    "largesize", "co64_largesize"])
def test_layouts_read_as_videocapture_reads_them(layout, tmp_path):
    tree = _tree()
    kinds = [b[0] for b in tree]
    assert kinds.index(b"moov") > kinds.index(b"mdat")   # cv2's layout
    moov_first = [k for k in kinds if k != b"moov"]
    moov_first.insert(1, b"moov")
    data = {"as_written": lambda: serialize(tree),
            "moov_first": lambda: relaid(tree, moov_first),
            "co64": lambda: relaid(tree, moov_first, wide=True),
            "largesize": lambda: relaid(tree, kinds, large={b"mdat"}),
            "co64_largesize": lambda: relaid(tree, moov_first, wide=True,
                                             large={b"mdat"})}[layout]()
    if "co64" in layout:
        assert b"co64" in data and b"stco" not in data
    if "largesize" in layout:
        at = data.index(b"mdat")
        assert struct.unpack(">I", data[at - 4: at])[0] == 1
    _equal_to_cv2(_write(tmp_path, "v.mp4", data))


def _retimed(tree, timescale, delta):
    mdhd = find(tree, b"moov", b"trak", b"mdia", b"mdhd")
    b = bytearray(mdhd[1])
    b[12:16] = struct.pack(">I", timescale)
    dur = struct.unpack(">I", b[16:20])[0]
    b[16:20] = struct.pack(">I", dur // 1024 * delta)
    mdhd[1] = bytes(b)
    stts = next(x for x in stbl(tree)[1] if x[0] == b"stts")
    n = struct.unpack(">I", stts[1][8:12])[0]
    stts[1] = struct.pack(">IIII", 0, 1, n, delta)
    edts = find(tree, b"moov", b"trak")[1]
    edts[:] = [x for x in edts if x[0] != b"edts"]


@pytest.mark.parametrize("timescale,delta,fps", [
    (10240, 1024, 10.0), (12800, 512, 25.0), (30000, 1001, 30000 / 1001),
    (15360, 512, 30.0)])
def test_rates_equal_cap_prop_fps(timescale, delta, fps, tmp_path):
    tree = _tree()
    _retimed(tree, timescale, delta)
    video = _equal_to_cv2(_write(tmp_path, "r.mp4", serialize(tree)))
    assert video.fps == fps


def _entry_renamed(tree, kind):
    stsd = next(x for x in stbl(tree)[1] if x[0] == b"stsd")
    stsd[1] = stsd[1].replace(b"mp4v", kind, 1)


def _refusal(case, tmp_path):
    tree = _tree()
    if case in ("avc1", "hvc1", "vp09", "av01", "xyz1"):
        _entry_renamed(tree, case.encode())
    elif case == "ctts":
        stbl(tree)[1].insert(2, [b"ctts", bytes(8)])
    elif case == "moof":
        tree.append([b"moof", bytes(16)])
    elif case == "past_end":
        set_offsets(tree, [c + 10 ** 6 for c in chunk_offsets(tree)])
    elif case == "no_video":
        hdlr = find(tree, b"moov", b"trak", b"mdia", b"hdlr")
        hdlr[1] = hdlr[1].replace(b"vide", b"soun", 1)
    elif case == "edit":
        elst = find(tree, b"moov", b"trak", b"edts", b"elst")
        b = bytearray(elst[1])
        b[12:16] = struct.pack(">I", 1024)          # media time 1024
        elst[1] = bytes(b)
    elif case == "variable":
        stts = next(x for x in stbl(tree)[1] if x[0] == b"stts")
        stts[1] = struct.pack(">IIIIII", 0, 2, 8, 1024, 8, 2048)
        trak = find(tree, b"moov", b"trak")[1]
        trak[:] = [x for x in trak if x[0] != b"edts"]
    elif case == "matroska":
        return _write(tmp_path, "v.mkv", b"\x1aE\xdf\xa3" + bytes(60))
    return _write(tmp_path, "v.mp4", serialize(tree))


@pytest.mark.parametrize("case,match", [
    ("avc1", "H.264"), ("hvc1", "HEVC"), ("vp09", "VP9"), ("av01", "AV1"),
    ("xyz1", "'xyz1' codec"), ("ctts", "ctts: B-frames"),
    ("moof", "fragmented MP4"), ("matroska", "Matroska"),
    ("past_end", "past the end of the file"), ("no_video", "no video track"),
    ("edit", "edit list"), ("variable", "variable frame rate")])
def test_refusals_name_what_is_refused(case, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        open_video(_refusal(case, tmp_path))


def test_truncated_and_corrupt_files_raise_value_errors(tmp_path):
    with open(CLIP, "rb") as f:
        data = f.read()
    rng = np.random.default_rng(0)
    for trial in range(30):
        d = bytearray(data)
        if trial % 2:
            d = d[: int(rng.integers(8, len(d)))]
        else:
            for _ in range(4):
                d[int(rng.integers(len(d) - 900, len(d)))] = int(
                    rng.integers(0, 256))
        path = _write(tmp_path, f"c{trial}.mp4", bytes(d))
        try:
            video = open_video(path)
            for f in video.frames():
                f()
        except ValueError:
            pass
