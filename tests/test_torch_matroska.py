"""The port's Matroska/WebM demuxer (``tpusr_torch/data/matroska.py``)
against ``cv2.VideoCapture`` (FFmpeg's ``matroska`` demuxer) on the CPU,
and ``preprocess`` on ``.webm`` and ``.mkv`` against the JAX package:

- the committed ``.mkv`` fixtures (``tests/data/webm/``): ``mp4v`` and
  ``MJPG`` that ``cv2.VideoWriter`` wrote, the 720p ``mp4v`` clip's first
  frames, and the rewrites of ``make_fixtures.CRAFTED`` (header
  stripping; the VP8 rewrites are in ``test_torch_vp8_video.py``), each
  against cv2 and the manifest;
- clips written here by ``cv2.VideoWriter`` (``mp4v``, ``MJPG`` and
  ``VP80`` in ``.mkv``) and files laid out here by
  ``tests/torch_video_writers.mkv``;
- the rate ``CAP_PROP_FPS`` gives at 30, 29.97, 25, 24 and 15 fps through
  ``DefaultDuration``;
- each refusal by name, and truncated or corrupted files, which raise
  only ``ValueError`` or read as cv2 reads them;
- the extractor on a ``.webm`` and a ``.mkv`` with JAX's draws against
  ``create_hr_lr_images_from_video``, and ``preprocess`` through both
  command lines.
"""

import os
import zlib

import cv2
import numpy as np
import pytest

import torch_video_writers as tw
from test_torch_video import (_assert_same_outputs, _jax_draws_fn, _load,
                              jcli, jv, tcli, tv)
from test_torch_vp8_video import FIXTURES, MANIFEST, assert_equal_to_cv2, fx
from tpusr_torch.data import matroska
from tpusr_torch.data.video import open_video

MKV = sorted(n for n in MANIFEST if n.endswith(".mkv") and n != fx.PRINT_MKV
             and n != "zlib_64x64.mkv")
PAN = os.path.join(FIXTURES, "pan_96x64.webm")


def _source(name=PAN):
    with open(name, "rb") as f:
        return matroska.demux(f.read(), name)


@pytest.mark.parametrize("name", MKV)
def test_committed_mkv_clips_equal_videocapture_and_the_manifest(name):
    assert_equal_to_cv2(os.path.join(FIXTURES, name), MANIFEST[name])


def test_the_720p_mkv_first_frames_equal_videocapture():
    path = os.path.join(FIXTURES, fx.PRINT_MKV)
    entry = MANIFEST[fx.PRINT_MKV]
    video = open_video(path)
    assert (len(video), video.fps) == (entry["frames"], entry["fps"])
    cap = cv2.VideoCapture(path)
    for i, frame in enumerate(video.frames()):
        ok, want = cap.read()
        got = frame()
        np.testing.assert_array_equal(got, want)
        assert fx.sha(got) == entry["sha256"][i]
        if i == 2:
            break


@pytest.mark.parametrize("fourcc,size,kind,fps", [
    ("mp4v", (88, 56), "pan", 24.0), ("MJPG", (64, 48), "static", 30.0),
    ("VP80", (80, 64), "cut", 15.0)])
def test_clips_written_now_equal_videocapture(fourcc, size, kind, fps,
                                              tmp_path):
    path = str(tmp_path / f"{kind}.mkv")
    fx.mfx.write_clip(path, fourcc, (fx.scene(kind, *size, t)
                                     for t in range(10)), fps=fps)
    assert_equal_to_cv2(path)


@pytest.mark.parametrize("fps,duration", [
    (30.0, 33333333), (29.97, 33366700), (25.0, 40000000), (24.0, 41666666),
    (15.0, 66666666)])
def test_rates_equal_cap_prop_fps(fps, duration, tmp_path):
    track, frames = _source()
    path = tmp_path / "r.webm"
    path.write_bytes(tw.mkv("V_VP8", 96, 64, frames[:4],
                            default_duration=duration))
    _, want = fx.read_cv2(str(path))
    assert open_video(str(path)).fps == want == fps


@pytest.mark.parametrize("opts", [
    dict(unknown_sizes=True, lacing="ebml"), dict(block_group=True,
                                                  audio=True),
    dict(lacing="xiph", encoding=("zlib",), frames_per_cluster=3),
    dict(unknown_sizes=True, block_group=True, doctype="matroska")])
def test_layouts_written_now_equal_videocapture(opts, tmp_path):
    track, frames = _source()
    path = tmp_path / "l.webm"
    path.write_bytes(tw.mkv("V_VP8", 96, 64, tw.encode_frames(
        frames, opts.get("encoding")), default_duration=40000000, **opts))
    assert len(assert_equal_to_cv2(str(path))) == 16


def _refusal(case, tmp_path):
    track, frames = _source()
    if case == "stub":
        data = b"\x1aE\xdf\xa3" + bytes(28)
    elif case == "encryption":
        data = tw.mkv("V_VP8", 96, 64, frames[:2], default_duration=40000000,
                      encoding=("zlib",))
        data = data.replace(b"\x50\x33\x81\x00", b"\x50\x33\x81\x01")
    elif case in ("bzlib", "lzo"):
        data = tw.mkv("V_VP8", 96, 64, frames[:2], default_duration=40000000,
                      encoding=("zlib",))
        data = data.replace(b"\x42\x54\x81\x00", b"\x42\x54\x81" + bytes(
            [1 if case == "bzlib" else 2]))
    elif case == "zlib_bomb":               # 200 MiB from one frame
        bomb = zlib.compress(frames[0] + bytes(200 << 20), 9)
        data = tw.mkv("V_VP8", 96, 64, [bomb], default_duration=40000000,
                      encoding=("zlib",))
    elif case == "no_duration":
        data = tw.mkv("V_VP8", 96, 64, frames[:2])
    elif case == "slow":
        data = tw.mkv("V_VP8", 96, 64, frames[:2], default_duration=250000000)
    elif case == "doctype":
        data = tw.mkv("V_VP8", 96, 64, frames[:2], default_duration=40000000,
                      doctype="webx")
    elif case == "no_height":
        data = tw.mkv("V_VP8", 96, 64, frames[:2], default_duration=40000000)
        data = data.replace(b"\xba\x81\x40", b"\xbb\x81\x40", 1)
    elif case == "no_video":
        data = tw.mkv("V_VP8", 96, 64, frames[:2], default_duration=40000000)
        data = data.replace(b"\x83\x81\x01", b"\x83\x81\x02", 1)
    elif case == "second_video":
        one = tw.mkv("V_VP8", 96, 64, frames[:2], default_duration=40000000)
        entry = tw.el(0xAE, [tw.el(0xD7, 1), tw.el(0x73C5, 1),
                             tw.el(0x83, 1), tw.el(0x86, "V_VP8"),
                             tw.el(0xE0, [tw.el(0xB0, 96), tw.el(0xBA, 64)]),
                             tw.el(0x23E383, 40000000)])
        two = tw.el(0xAE, [tw.el(0xD7, 2), tw.el(0x83, 1),
                           tw.el(0x86, "V_VP8")])
        old = tw.el(0x1654AE6B, [entry])
        assert old in one
        data = _resize_segment(one.replace(old, tw.el(0x1654AE6B,
                                                      [entry, two])))
    else:                                   # another codec
        data = tw.mkv(case, 96, 64, frames[:2], default_duration=40000000)
    path = tmp_path / "refused.mkv"
    path.write_bytes(data)
    return str(path)


def _resize_segment(data: bytes) -> bytes:
    """The Segment's size after an edit inside it (its header is the EBML
    header's end, an 8-byte ID + size)."""
    eid, body, stop = matroska.element(data, 0, len(data))
    seg_at = stop
    eid, seg_body, _ = matroska.element(data, seg_at, len(data))
    return data[:seg_at] + tw.el(matroska.SEGMENT, data[seg_body:])


@pytest.mark.parametrize("case,match", [
    ("stub", "Matroska"), ("encryption", "encryption"),
    ("bzlib", "bzlib compression"), ("lzo", "lzo1x compression"),
    ("zlib_bomb", "inflating past 67108864 bytes"),
    ("no_duration", "no DefaultDuration"), ("slow", "rate of 4/1 fps"),
    ("doctype", "DocType"), ("no_video", "no video track"),
    ("no_height", "without its PixelWidth and PixelHeight"),
    ("second_video", "second video track"),
    ("V_MPEG4/ISO/AVC", "H.264"), ("V_MPEGH/ISO/HEVC", "HEVC"),
    ("V_AV1", "AV1"), ("V_VP9", "VP9"), ("V_FFV1", "FFV1"),
    ("V_THEORA", "Theora"), ("V_XYZ", "'V_XYZ'")])
def test_refusals_name_what_is_refused(case, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        open_video(_refusal(case, tmp_path))


def test_an_ffv1_file_that_cv2_wrote_is_refused_by_name(tmp_path):
    path = str(tmp_path / "f.mkv")
    fx.mfx.write_clip(path, "FFV1", (fx.scene("pan", 32, 32, t)
                                     for t in range(2)))
    with pytest.raises(ValueError, match="FFV1"):
        open_video(path)


@pytest.mark.parametrize("seed", range(4))
def test_truncated_and_corrupt_files_raise_value_errors_or_equal_cv2(
        seed, tmp_path):
    """Cuts anywhere, and bytes flipped in the element headers."""
    with open(os.path.join(FIXTURES, "live_96x64.webm" if seed % 2 else
                           "groups_80x48.webm"), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(seed)
    for trial in range(6):
        d = bytearray(data)
        if trial % 2:
            d = d[: int(rng.integers(4, len(d)))]
        else:
            for _ in range(2):
                d[int(rng.integers(0, 400))] ^= 1 << int(rng.integers(0, 8))
        path = str(tmp_path / f"c{trial}.webm")
        with open(path, "wb") as f:
            f.write(bytes(d))
        try:
            got = [g() for g in open_video(path).frames()]
        except ValueError:
            continue
        want, _ = fx.read_cv2(path)
        assert len(got) == len(want), trial
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------- the extractor and CLIs
@pytest.mark.parametrize("name,first", [("pan_96x64.webm", 3),
                                        ("pan_96x64.mkv", 2)])
def test_extractor_on_jax_draws_equals_jax(name, first, tmp_path):
    """As ``test_torch_video``'s for ``.avi`` and ``.mp4``: the port reads
    the clip with its own reader, at 0.25 s a frame and then continuing
    the numbering."""
    clip = os.path.join(FIXTURES, name)
    video = tv.open_video(clip)
    for run, kw in enumerate(({}, {"skip_seconds": 0.25, "max_frames": 1})):
        out = {}
        for pkg in ("jax", "torch"):
            root = str(tmp_path / pkg)
            args = dict(hr_dir=os.path.join(root, "HR"),
                        lr_dir=os.path.join(root, "LR"), hr_size=48,
                        frame_interval_seconds=0.25,
                        interpolation_map_path=os.path.join(root, "imap.pkl"),
                        class_labels_map_path=os.path.join(root, "cmap.pkl"),
                        class_id=1, seed=3 + run, **kw)
            if pkg == "jax":
                out[pkg] = jv.create_hr_lr_images_from_video(clip, **args)
            else:
                out[pkg] = tv.create_hr_lr_images_from_frames(
                    video.frames(), video.fps, device="cpu",
                    draws_fn=_jax_draws_fn(3 + run), **args)
        assert out["torch"] == out["jax"]
        assert len(out["jax"]) == (first if run == 0 else 1)
        _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "torch"),
                             out["jax"])
    for m in ("imap.pkl", "cmap.pkl"):
        assert _load(str(tmp_path / "torch" / m)) == _load(
            str(tmp_path / "jax" / m))


@pytest.mark.parametrize("name,pairs", [("cut_144x80.webm", 1),
                                        ("static_80x48.mkv", 1)])
def test_preprocess_through_both_command_lines(name, pairs, tmp_path,
                                               capsys):
    """The same files, HR and LR pixels, interpolation map and class map
    from both commands: the port draws JAX's degradations from the seed."""
    clip = os.path.join(FIXTURES, name)
    for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
        root = tmp_path / pkg
        argv = ["preprocess", "--video", clip, "--hr-dir", str(root / "HR"),
                "--lr-dir", str(root / "LR"), "--hr-size", "32",
                "--interp-map", str(root / "m.pkl"), "--class-map",
                str(root / "c.pkl"), "--class-id", "1", "--seed", "2"]
        main(argv + (["--device", "cpu"] if pkg == "torch" else []))
        assert f"wrote {pairs} HR/LR pairs" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax" / "HR"))
    assert sorted(os.listdir(tmp_path / "torch" / "HR")) == names
    for n in names:
        for d in ("HR", "LR"):
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "torch" / d / n)),
                cv2.imread(str(tmp_path / "jax" / d / n)))
    assert _load(str(tmp_path / "torch" / "m.pkl")) == _load(
        str(tmp_path / "jax" / "m.pkl"))
    assert _load(str(tmp_path / "torch" / "c.pkl")) == _load(
        str(tmp_path / "jax" / "c.pkl"))
