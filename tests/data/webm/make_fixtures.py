"""Write the Matroska/WebM video fixtures beside this file, with OpenCV's
answers, for ``tests/test_torch_matroska.py`` and
``tests/test_torch_vp8_video.py`` and for checks on a machine that has no
OpenCV (``chip_smoke.py``'s preprocess phase):

- ``print_720p.webm``: the print of ``tests/data/video/make_fixtures.py``
  moving over the bed, 1280x720 at 10 fps, written by ``cv2.VideoWriter``
  as ``VP80`` (libvpx) in WebM; 16 frames (two key frames), as libvpx's
  ~57 KB frames would make the 40 of the ``.mp4`` 2.3 MB;
- ``print_720p.mkv``: the same 40 frames as ``mp4v`` in Matroska;
- the small clips of ``CLIPS``, each written by ``cv2.VideoWriter`` with
  its fourcc at its rate (30, 29.97, 25, 24 and 15 fps among them), their
  scenes those of ``tests/data/mpeg4/make_fixtures.py``;
- ``CRAFTED``: those clips' frames laid out again by
  ``tests/torch_video_writers.mkv`` (unknown sizes, each lacing,
  BlockGroups, zlib, header stripping, an audio track, a file cut inside a
  Cluster), and VP8 streams written by ``Vp8StreamWriter``: every
  interframe tool that libvpx does not write by default (hidden frames,
  buffer copies, sign biases, kept probabilities, kept segment maps,
  profiles 1-3, scaling bits, a full-range key frame, an odd width);
- ``manifest.json``: per file, ``cv2.VideoCapture``'s rate, frame count
  and the sha256 of each frame's BGR bytes, and what the port's decoder
  counted in it (``counts``).

    python tests/data/webm/make_fixtures.py

Needs OpenCV (and the port, for the counts and for the writers' state).
"""

import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
for p in (REPO, os.path.join(REPO, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch_video_writers as tw  # noqa: E402
from tpusr_torch.data import matroska  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "mpeg4_fixtures", os.path.join(REPO, "tests", "data", "mpeg4",
                                   "make_fixtures.py"))
mfx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mfx)
sha, scene, read_cv2 = mfx.sha, mfx.scene, mfx.read_cv2

# name -> (fourcc, (width, height), frames, scene, fps)
CLIPS = {
    "pan_96x64.webm": ("VP80", (96, 64), 16, "pan", 25.0),
    "noise_64x64.webm": ("VP80", (64, 64), 16, "noise", 30.0),
    "cut_144x80.webm": ("VP80", (144, 80), 16, "cut", 29.97),
    "static_80x48.webm": ("VP80", (80, 48), 16, "static", 24.0),
    "edge_70x50.webm": ("VP80", (70, 50), 12, "edge", 15.0),
    "pan_96x64.mkv": ("mp4v", (96, 64), 12, "pan", 25.0),
    "static_80x48.mkv": ("MJPG", (80, 48), 8, "static", 15.0),
}
PRINT_WEBM, PRINT_MKV = "print_720p.webm", "print_720p.mkv"
PRINT_FRAMES = {PRINT_WEBM: 16, PRINT_MKV: 40}
# name -> (source clip, mkv() options); the frames re-encoded if needed
CRAFTED = {
    "live_96x64.webm": ("pan_96x64.webm", dict(unknown_sizes=True)),
    "xiph_96x64.webm": ("pan_96x64.webm", dict(lacing="xiph")),
    "ebml_96x64.webm": ("pan_96x64.webm", dict(lacing="ebml")),
    "fixed_96x64.webm": ("pan_96x64.webm", dict(lacing="fixed")),
    "groups_80x48.webm": ("static_80x48.webm", dict(block_group=True)),
    "zlib_64x64.mkv": ("noise_64x64.webm", dict(encoding=("zlib",))),
    "strip_96x64.mkv": ("pan_96x64.mkv",
                        dict(encoding=("strip", b"\0\0\1"))),
    "strip_80x48.mkv": ("static_80x48.mkv", dict(encoding=("strip", None))),
    "audio_144x80.webm": ("cut_144x80.webm", dict(audio=True)),
    "cut_96x64.webm": ("pan_96x64.webm", dict(frames_per_cluster=4)),
}
CODECS = {"VP80": "V_VP8", "mp4v": "V_MPEG4/ISO/ASP", "MJPG": "V_MJPEG"}
# hand-written VP8 streams: name -> (width, height, profile)
STREAMS = {"tools_80x64.webm": (80, 64, 0), "odd_63x48.webm": (63, 48, 0),
           "profile1_64x48.webm": (64, 48, 1),
           "profile2_64x48.webm": (64, 48, 2),
           "profile3_64x48.webm": (64, 48, 3)}
SEG = dict(quant=[0, 12, -8, 20], lf=[0, 6, -4, 10], map_probs=[96, 128, 160])


def write_named_clip(directory: str, name: str) -> str:
    """Write ``CLIPS[name]`` (or a print clip) into ``directory``."""
    path = os.path.join(directory, name)
    if name in PRINT_FRAMES:
        mfx.write_clip(path, "VP80" if name.endswith(".webm") else "mp4v",
                       (mfx.vfx.print_frame(i)
                        for i in range(PRINT_FRAMES[name])))
        return path
    fourcc, (w, h), n, kind, fps = CLIPS[name]
    mfx.write_clip(path, fourcc, (scene(kind, w, h, t) for t in range(n)),
                   fps=fps)
    return path


def crafted_bytes(directory: str, name: str) -> bytes:
    """``CRAFTED[name]``: its source clip's frames in another layout."""
    source, opts = CRAFTED[name]
    with open(os.path.join(directory, source), "rb") as f:
        track, frames = matroska.demux(f.read(), source)
    fourcc, (w, h) = CLIPS[source][:2]
    opts = dict(opts)
    if opts.get("lacing") == "fixed":       # trailing zeros end a VP8 frame
        size = max(len(f) for f in frames)
        frames = [f + bytes(size - len(f)) for f in frames]
    if opts.get("encoding") == ("strip", None):
        opts["encoding"] = ("strip", os.path.commonprefix(frames))
    data = tw.mkv(CODECS[fourcc], w, h, tw.encode_frames(
        frames, opts.get("encoding")), default_duration=(
        track.default_duration), private=track.private,
        doctype="webm" if name.endswith(".webm") else "matroska", **opts)
    if name.startswith("cut_"):             # inside the last Cluster
        data = data[:len(data) - len(frames[-1]) // 2 - 40]
    return data


def tools_stream(rng, w: int, h: int) -> list:
    """A VP8 stream that meets every tool of ``vp8video.TOOLS`` that libvpx
    does not write by default, in a fixed order."""
    s = tw.Vp8StreamWriter(rng, w, h)
    s.key(segments=SEG, scaling=(1, 2), level=30)
    s.inter(refresh_golden=1, sign_bias=(1, 0), partitions=2,
            lf_delta=([2, -3, 4, -5], [1, -2, 3, -4]),
            segments={"map_probs": None}, ymode_probs=[90, 100, 120, 50],
            uv_probs=[150, 110, 200], mv_updates=0.5, prob_updates=0.02)
    s.inter(refresh_alt=1, sign_bias=(1, 1), lf_delta="keep",
            segments={"map_probs": [80, 140, 200], **{
                k: SEG[k] for k in ("quant", "lf")}, "absolute": True})
    s.inter(copy_gf=1, copy_arf=2, refresh_entropy=0, skip_prob=None,
            filter_type="simple", segments={"map_probs": None},
            lf_delta=([None, 6, None, -6], [None, None, 5, None]))
    s.inter(show=0, copy_gf=2, copy_arf=1, refresh_last=0, intra=0.4,
            sign_bias=(0, 1))
    s.inter(level=0, intra=0.5, partitions=4)
    s.key(clamping=1, level=20)
    s.inter(sharpness=5, level=40, q_index=100, modes=(0.1,) * 4 + (0.6,))
    s.inter(show=0, refresh_golden=1, refresh_alt=1, refresh_last=0)
    s.inter(refs=(0.2, 0.4, 0.4), long_mv=0.6, max_mv=200)
    return s.frames


def stream_bytes(name: str) -> bytes:
    w, h, profile = STREAMS[name]
    rng = np.random.default_rng(sorted(STREAMS).index(name))
    if name.startswith("tools"):
        frames = tools_stream(rng, w, h)
    else:
        frames = tw.random_tools_stream(rng, w, h, 10, profile=profile)
    return tw.mkv("V_VP8", w, h, frames, default_duration=40000000)


def clip_entry(path: str) -> dict:
    from tpusr_torch.data.video import open_video

    frames, fps = read_cv2(path)
    video = open_video(path)
    for _ in video.frames():
        pass
    return {"fps": fps, "frames": len(frames), "height": frames[0].shape[0],
            "width": frames[0].shape[1], "sha256": [sha(f) for f in frames],
            "counts": dict(sorted(getattr(video, "counts", {}).items()))}


def main() -> None:
    clips = {}
    for name in (PRINT_WEBM, PRINT_MKV, *CLIPS):
        clips[name] = clip_entry(write_named_clip(HERE, name))
    for name in CRAFTED:
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(crafted_bytes(HERE, name))
        clips[name] = clip_entry(path)
    for name in STREAMS:
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(stream_bytes(name))
        clips[name] = clip_entry(path)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"clips": clips}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
