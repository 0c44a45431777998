"""The port's VP8 video decoder (``tpusr_torch/data/vp8video.py``, on
``pipeline/vp8.py``'s shared parts and ``data/swscale.py``) against
``cv2.VideoCapture`` (FFmpeg's ``vp8`` decoder) on the CPU, with no
tolerance: the rate, the frame count and every frame's bytes.

- the committed VP8 fixtures (``tests/data/webm/``, ``make_fixtures.py``):
  the clips ``cv2.VideoWriter`` wrote (libvpx) and the hand-written
  streams of ``tests/torch_video_writers.py`` against cv2 and the
  manifest's hashes and counts, the 720p clip's first frames;
- clips written here by ``cv2.VideoWriter`` (``VP80``) at sizes and
  contents of their own, and hand-written streams with other seeds under
  each profile;
- the coverage count: each tool the decoder implements is met in the
  fixtures, each tool it refuses raises a ``ValueError`` that names it,
  and corrupted streams raise only ``ValueError`` or decode as cv2 does.
"""

import collections
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest

import torch_video_writers as tw
from tpusr_torch.data import vp8video
from tpusr_torch.data.video import open_video

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "webm")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["clips"]
_spec = importlib.util.spec_from_file_location(
    "webm_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

VP8 = sorted(n for n in MANIFEST if n.endswith(".webm") and n != fx.PRINT_WEBM
             or n == "zlib_64x64.mkv")


def assert_equal_to_cv2(path, entry=None):
    """The port's frames, rate and count against cv2's (and the
    manifest's); returns the port's video."""
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
        assert dict(getattr(video, "counts", {})) == entry["counts"]
    return video


def write_stream(path, frames, w, h, fps_ns=40000000):
    with open(path, "wb") as f:
        f.write(tw.mkv("V_VP8", w, h, frames, default_duration=fps_ns))
    return str(path)


@pytest.mark.parametrize("name", VP8)
def test_committed_vp8_clips_equal_videocapture_and_the_manifest(name):
    assert_equal_to_cv2(os.path.join(FIXTURES, name), MANIFEST[name])


def test_the_720p_clip_first_frames_equal_videocapture():
    """Its key frame and the interframe after it on the CPU (~1 s a
    frame); the card's phase holds all 16 to the manifest."""
    path = os.path.join(FIXTURES, fx.PRINT_WEBM)
    entry = MANIFEST[fx.PRINT_WEBM]
    video = open_video(path)
    assert (len(video), video.fps) == (entry["frames"], entry["fps"])
    cap = cv2.VideoCapture(path)
    for i, frame in enumerate(video.frames()):
        got = frame()
        ok, want = cap.read()
        assert ok and got.shape == (720, 1280, 3)
        np.testing.assert_array_equal(got, want)
        assert fx.sha(got) == entry["sha256"][i]
        if i == 1:
            break
    cap.release()


@pytest.mark.parametrize("size,kind,fps", [
    ((112, 80), "pan", 30.0), ((48, 48), "noise", 25.0),
    ((160, 96), "cut", 24.0), ((62, 34), "edge", 29.97)])
def test_clips_written_now_equal_videocapture(size, kind, fps, tmp_path):
    path = str(tmp_path / f"{kind}.webm")
    fx.mfx.write_clip(path, "VP80", (fx.scene(kind, *size, t)
                                     for t in range(10)), fps=fps)
    video = assert_equal_to_cv2(path)
    assert video.counts["inter_frame"] > 0


@pytest.mark.parametrize("seed,profile,size", [
    (21, 0, (48, 32)), (22, 1, (40, 24)), (23, 2, (57, 40)),
    (24, 3, (32, 48))])
def test_hand_written_streams_equal_videocapture(seed, profile, size,
                                                 tmp_path):
    frames = tw.random_tools_stream(np.random.default_rng(seed), *size, 8,
                                    profile=profile)
    video = assert_equal_to_cv2(write_stream(tmp_path / "s.webm", frames,
                                             *size))
    assert video.counts[f"profile_{profile}"] == 8


def test_random_access_decodes_the_frames_before():
    path = os.path.join(FIXTURES, "tools_80x64.webm")
    video = open_video(path)
    entry = MANIFEST["tools_80x64.webm"]
    for i in (0, 3, len(video) - 1):
        assert fx.sha(video.frame(i)) == entry["sha256"][i]


def test_every_tool_is_met_in_the_fixtures():
    """Each count the decoder keeps is one of ``TOOLS``, and each of
    ``TOOLS`` is met in the committed files (the 720p clip included)."""
    met = collections.Counter()
    for entry in MANIFEST.values():
        met.update(entry["counts"])
    vp8_counts = {k for e in MANIFEST.values() for k in e["counts"]
                  if e["counts"].get("key_frame")}
    assert vp8_counts <= set(vp8video.TOOLS)
    assert [t for t in vp8video.TOOLS if not met[t]] == []


def _refusal(case, tmp_path):
    rng = np.random.default_rng(7)
    s = tw.Vp8StreamWriter(rng, 48, 32)
    s.key()
    s.inter()
    frames = list(s.frames)
    w, h = 48, 32
    if case == "profile":
        frames[1] = bytes([frames[1][0] | 0x0A]) + frames[1][1:]   # 5
    elif case == "odd_height":
        s = tw.Vp8StreamWriter(rng, 48, 31)
        s.key()
        frames, h = s.frames, 31
    elif case == "size_change":
        s2 = tw.Vp8StreamWriter(rng, 64, 32)
        frames.append(s2.key())
    elif case == "kept_map":
        frames.append(_kept_map_frame(rng))
    elif case == "no_key":                   # a key frame after it
        frames = frames[1:] + frames[:1]
    elif case == "partition":
        d = bytearray(frames[0])
        d[0:3] = ((len(d) << 5) | (d[0] & 0x1F)).to_bytes(3, "little")
        frames[0] = bytes(d)
    elif case == "tag":
        frames[1] = frames[1][:2]
    return write_stream(tmp_path / f"{case}.webm", frames, w, h)


def _kept_map_frame(rng):
    """An interframe that keeps the segment map, written by a writer whose
    decoder is told it has one (the stream it follows has none)."""
    s = tw.Vp8StreamWriter(rng, 48, 32)
    s.key()
    s.dec.seg_map = [0] * 6
    return s.inter(segments={"map_probs": None})


@pytest.mark.parametrize("case,match", [
    ("profile", "profile 5"), ("odd_height", "odd height 31"),
    ("size_change", "change of frame size"),
    ("kept_map", "segment map kept when none was sent"),
    ("no_key", "does not start with a key frame"),
    ("partition", "first partition runs past"),
    ("tag", "shorter than its tag")])
def test_refusals_name_what_is_refused(case, match, tmp_path):
    path = _refusal(case, tmp_path)
    with pytest.raises(ValueError, match=match):
        for f in open_video(path).frames():
            f()


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_streams_raise_value_errors_or_equal_videocapture(
        seed, tmp_path):
    """Bytes flipped in the frames' payloads (headers and partitions):
    the port either refuses with a ValueError or gives cv2's frames."""
    rng = np.random.default_rng(seed)
    path = os.path.join(FIXTURES, "pan_96x64.webm")
    from tpusr_torch.data import matroska
    with open(path, "rb") as f:
        track, frames = matroska.demux(f.read(), path)
    frames = list(frames)
    for _ in range(3):
        k = int(rng.integers(0, len(frames)))
        d = bytearray(frames[k])
        d[int(rng.integers(0, len(d)))] ^= 1 << int(rng.integers(0, 8))
        frames[k] = bytes(d)
    out = write_stream(tmp_path / "c.webm", frames, 96, 64)
    try:
        video = open_video(out)
        got = [f() for f in video.frames()]
    except ValueError:
        return
    want, _ = fx.read_cv2(out)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
