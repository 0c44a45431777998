"""The port's MPEG-4 Part 2 reader (``tpusr_torch/data/mpeg4.py``, with
``data/swscale.py``, ``data/idct.py`` and the containers
``data/isobmff.py`` and ``data/avi.py``) against ``cv2.VideoCapture``
(FFmpeg) on the CPU, with no tolerance: the rate, the frame count and every
frame's bytes.

- the committed fixtures (``tests/data/mpeg4/``, ``make_fixtures.py``):
  the small clips and the hand-written stream against cv2 and against the
  manifest's hashes, the 720p clip's first three frames;
- clips written here by ``cv2.VideoWriter`` (``mp4v`` in ``.mp4`` and
  ``.mov``; ``XVID``, ``DIVX`` and ``FMP4`` in ``.avi``) at sizes that are
  not multiples of 16, and hand-written streams with other seeds;
- the coverage count: each tool the decoder implements is met in the
  fixtures, and each tool it refuses raises a ``ValueError`` that names
  it.
"""

import importlib.util
import json
import os

import cv2
import numpy as np
import pytest

from tpusr_torch.data import mpeg4
from tpusr_torch.data.video import open_video

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "mpeg4")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["clips"]
_spec = importlib.util.spec_from_file_location(
    "mpeg4_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

SMALL = sorted(n for n in MANIFEST if n != fx.PRINT)
# every tool the decoder implements, by its count
TOOLS = ["i_vop", "p_vop_rounding0", "p_vop_rounding1", "mb_intra_i",
         "mb_intra_p", "mb_inter", "mb_not_coded", "ac_pred", "dc_in_ac",
         "escape1", "escape2", "escape3", "f_code_2_or_more", "mv_outside",
         "vop_not_coded", "hpel_chroma_approx_differs"] + [
    f"hpel_{d}_rounding{r}" for d in ("x", "y", "xy") for r in (0, 1)]


def _assert_equal_to_cv2(path, entry=None):
    want, fps = fx.read_cv2(path)
    video = open_video(path)
    assert video.fps == fps
    got = [f() for f in video.frames()]
    assert len(video) == len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    if entry is not None:
        assert (fps, len(want)) == (entry["fps"], entry["frames"])
        assert [fx.sha(g) for g in got] == entry["sha256"]
        assert dict(video.counts) == entry["counts"]
    return video


@pytest.mark.parametrize("name", SMALL)
def test_committed_clips_equal_videocapture_and_the_manifest(name):
    _assert_equal_to_cv2(os.path.join(FIXTURES, name), MANIFEST[name])


def test_the_720p_clip_first_frames_equal_videocapture():
    """Three of its 40 frames on the CPU (~0.5 s a frame); the card's phase
    holds all 40 to the manifest."""
    path = os.path.join(FIXTURES, fx.PRINT)
    entry = MANIFEST[fx.PRINT]
    video = open_video(path)
    assert (len(video), video.fps) == (entry["frames"], entry["fps"])
    assert (video.width, video.height) == (1280, 720)
    cap = cv2.VideoCapture(path)
    for i, frame in enumerate(video.frames()):
        got = frame()
        ok, want = cap.read()
        assert ok
        np.testing.assert_array_equal(got, want)
        assert fx.sha(got) == entry["sha256"][i]
        if i == 0:
            np.testing.assert_array_equal(
                got, cv2.imread(os.path.join(FIXTURES, "print_720p_f0.png")))
        if i == 2:
            break
    cap.release()


@pytest.mark.parametrize("fourcc,ext,size,kind", [
    ("mp4v", "mp4", (88, 56), "pan"),
    ("mp4v", "mov", (64, 64), "static"),
    ("XVID", "avi", (120, 72), "noise"),
    ("DIVX", "avi", (70, 50), "edge"),
    ("FMP4", "avi", (160, 96), "cut"),
])
def test_clips_written_now_equal_videocapture(fourcc, ext, size, kind,
                                              tmp_path):
    path = str(tmp_path / f"{kind}.{ext}")
    fx.write_clip(path, fourcc, (fx.scene(kind, *size, t) for t in range(12)),
                  fps=25.0)
    video = _assert_equal_to_cv2(path)
    assert (video.width, video.height) == size


@pytest.mark.parametrize("seed,size", [(1, (48, 32)), (2, (40, 24))])
def test_hand_written_streams_equal_videocapture(seed, size, tmp_path):
    path = str(tmp_path / "crafted.avi")
    fx.vfx.write_avi(path, fx.crafted_samples(*size, seed=seed), *size,
                     fourcc=b"FMP4")
    video = _assert_equal_to_cv2(path)
    assert video.counts["hpel_chroma_approx_differs"] > 0


def test_random_access_decodes_from_the_last_i_vop():
    """The encoder starts a GOP at the scene cut (frame 7)."""
    path = os.path.join(FIXTURES, "cut_144x80.avi")
    video = open_video(path)
    entry = MANIFEST["cut_144x80.avi"]
    assert video.intra == [0, 7]
    for i in (15, 0, 6, 7, 9):
        assert fx.sha(video.frame(i)) == entry["sha256"][i]


def test_every_tool_is_met_in_the_fixtures():
    total = {}
    for name in MANIFEST:
        for k, v in MANIFEST[name]["counts"].items():
            total[k] = total.get(k, 0) + v
    missing = [t for t in TOOLS if total.get(t, 0) < 1]
    assert not missing, missing
    assert set(total) <= set(TOOLS), sorted(set(total) - set(TOOLS))


def _p_vop_with_mb(mcbpc_bits: str) -> bytes:
    o = fx.vop_header(1, 2)
    o.put(0, 1).put(int(mcbpc_bits, 2), len(mcbpc_bits)).put(0xFFFF, 16)
    return o.align().bytes()


@pytest.mark.parametrize("fields,match", [
    ({"interlaced": 1}, "interlaced"),
    ({"obmc_disable": 0}, "OBMC"),
    ({"sprite": 1}, "sprites/GMC"),
    ({"not_8_bit": 1}, "not_8_bit"),
    ({"quant_type": 1}, "MPEG quantisation"),
    ({"verid": 2, "quarter_sample": 1}, "quarter-pel"),
    ({"complexity_disable": 0}, "complexity estimation"),
    ({"resync_disable": 0}, "resync markers"),
    ({"data_partitioned": 1}, "data partitioning"),
    ({"scalability": 1}, "scalability"),
    ({"shape": 1}, "not rectangular"),
    ({"chroma_format": 2}, "chroma format"),
    ({"low_delay": 0}, "B-VOPs"),
    ({"vo_type": 17}, "not Simple"),
    ({"video_signal_type": 1}, "video_signal_type"),
])
def test_vol_tools_are_refused_by_name(fields, match):
    with pytest.raises(ValueError, match=match):
        mpeg4.read_headers(fx.headers(48, 32, **fields))


@pytest.mark.parametrize("sample,match", [
    (fx.vop_header(2, 2).align().bytes(), "B-VOPs"),
    (fx.vop_header(3, 2).align().bytes(), "S-VOPs"),
    (_p_vop_with_mb("010"), "INTER4V"),
    (_p_vop_with_mb("011"), "dquant"),
    (_p_vop_with_mb("000100"), "dquant"),
    (fx.p_vop([[(0, 0)] * 3] * 2) * 2, "packed bitstream"),
])
def test_vop_tools_are_refused_by_name(sample, match):
    head = fx.headers(48, 32)
    dec = mpeg4.Mpeg4Decoder(mpeg4.read_headers(head)[0])
    y = np.full((32, 48), 128)
    dec.decode(head + fx.i_vop((y, y[::2, ::2], y[::2, ::2])))
    with pytest.raises(ValueError, match=match):
        dec.decode(sample)


def test_streams_of_other_encoders_are_refused_by_name():
    for user, fourcc in ((b"XviD0050", "FMP4"), (b"DivX503b1393p", "DIVX"),
                         (b"", "XVID")):
        vol = mpeg4.read_headers(fx.headers(48, 32, user=user))[0]
        with pytest.raises(ValueError, match="another encoder"):
            mpeg4.check_encoder(vol, fourcc)
    mpeg4.check_encoder(mpeg4.read_headers(fx.headers(48, 32))[0], "XVID")


def test_corrupt_samples_raise_only_value_errors():
    samples = fx.crafted_samples(48, 32, seed=3)
    rng = np.random.default_rng(0)
    vol = mpeg4.read_headers(samples[0])[0]
    for trial in range(40):
        dec = mpeg4.Mpeg4Decoder(vol)
        dec.decode(samples[0])
        s = bytearray(samples[1 + trial % 4])
        if trial % 2:
            s = s[: int(rng.integers(8, len(s)))]
        else:
            for _ in range(3):
                s[int(rng.integers(8, len(s)))] ^= int(rng.integers(1, 256))
        try:
            dec.decode(bytes(s))
        except ValueError:
            pass
