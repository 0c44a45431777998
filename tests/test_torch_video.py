"""The port's ``preprocess`` path (``tpusr_torch/data/video.py``,
``data/avi.py``, the crop's ops in ``data/_cv_ops.py``) against OpenCV and
the JAX package's ``tpusr/data/video.py``, on the CPU:

- Otsu's threshold, the external contours (points and order), their areas
  and bounding boxes against cv2 on frames with several blobs, holes with a
  blob inside, blobs at the border, two blobs of equal area, lines of area
  0 and no blob, and on random thresholded images;
- ``smart_square_crop`` against JAX's on those frames and on video frames;
- the MJPEG-AVI reader against ``cv2.VideoCapture`` (FFmpeg): the rate,
  the frame count and every frame of the committed clips
  (``tests/data/video/``, ``make_fixtures.py``) and of AVIs written here
  (4:2:2, gray, odd width, another rate), and the readers' refusals (the
  MPEG-4 reader is held in ``test_torch_mpeg4.py``, Matroska and VP8 in
  ``test_torch_matroska.py`` and ``test_torch_vp8_video.py``);
- the extractor on the MJPEG AVI and on an ``mp4v`` MP4
  (``tests/data/mpeg4/``) with JAX's draws (``split`` of the key per
  written frame) against ``create_hr_lr_images_from_video``: the PNG
  pixels and the pickled maps, for both variants and continued numbering;
- ``preprocess`` through both command lines on ``--device cpu`` on both
  clips, and the port's refusal without a card.
"""

import hashlib
import importlib.util
import json
import os
import pickle

import cv2
import jax
import numpy as np
import pytest
import torch

import tpusr.cli.__main__ as jcli
import tpusr_torch.cli.__main__ as tcli
from test_torch_degrade import jax_draws
from torch_video_writers import mkv as mkv_file
from tpusr.data import video as jv
from tpusr_torch.data import _cv_ops as ops
from tpusr_torch.data import avi
from tpusr_torch.data import video as tv

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "video_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


MPEG4_CLIP = os.path.join(os.path.dirname(FIXTURES), "mpeg4", "pan_96x64.mp4")


def _clip(name):
    return MPEG4_CLIP if name.endswith(".mp4") else os.path.join(FIXTURES,
                                                                 name)


# ----------------------------------------------------------------- crop ops
def _scene(name):
    img = np.full((60, 80, 3), 25, np.uint8)
    if name == "several":
        img[5:20, 5:30] = (200, 180, 160)
        img[30:55, 40:75] = (230, 220, 210)
        cv2.circle(img, (15, 45), 8, (190, 190, 190), -1)
    elif name == "holes":
        img[5:55, 5:45] = 220
        img[15:45, 15:35] = 25                 # a hole ...
        img[25:35, 22:28] = 220                # ... with a blob inside
        img[10:20, 55:75] = 210
    elif name == "border":
        img[0:12, 0:20] = 220
        img[45:60, 60:80] = 230
        img[20:40, 79:80] = 200
    elif name == "equal":
        img[10:20, 10:30] = 220                # two 10x20 blobs
        img[35:45, 50:70] = 220
    elif name == "lines":
        img[10, 5:70] = 230                    # area 0
        img[20:50, 40] = 230
        img[55, 10] = 230
        img[30:33, 10:13] = 230
    elif name == "none":
        img[:] = 0
    return img


SCENES = ["several", "holes", "border", "equal", "lines", "none"]


def _assert_contours_equal(mask):
    want, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    got = ops.external_contours(torch.from_numpy(mask))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.reshape(-1, 2))
        assert ops.contour_area(g) == cv2.contourArea(w)
        assert ops.bounding_rect(g) == cv2.boundingRect(w)


@pytest.mark.parametrize("name", SCENES)
def test_crop_ops_equal_cv2_on_the_scenes(name):
    img = _scene(name)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    t, mask = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    tg, mg = ops.otsu_threshold(ops.bgr2gray(torch.from_numpy(img)))
    assert tg == t
    np.testing.assert_array_equal(mg.numpy(), mask)
    _assert_contours_equal(mask)


@pytest.mark.parametrize("seed", range(4))
def test_crop_ops_equal_cv2_on_random_images(seed):
    rng = np.random.default_rng(seed)
    for trial in range(25):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        g = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if trial % 2:
            g = cv2.GaussianBlur(g, (5, 5), 0)
        t, mask = cv2.threshold(g, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        tg, mg = ops.otsu_threshold(torch.from_numpy(g))
        assert tg == t
        np.testing.assert_array_equal(mg.numpy(), mask)
        _assert_contours_equal(mask)


def test_equal_areas_keep_the_first_contour_as_cv2_orders_them():
    img = _scene("equal")
    crop = tv.smart_square_crop(img)
    want = jv.smart_square_crop(img)
    np.testing.assert_array_equal(crop, want)
    # cv2 lists the lower blob first, so max() keeps it
    contours = ops.external_contours(torch.from_numpy(
        (cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) > 100).astype(np.uint8)))
    assert ops.bounding_rect(contours[0])[1] == 35


@pytest.mark.parametrize("name", SCENES + ["tall"])
def test_smart_square_crop_equals_jax(name):
    img = _scene(name) if name != "tall" else np.ascontiguousarray(
        _scene("several").transpose(1, 0, 2))
    want = jv.smart_square_crop(img)
    got = tv.smart_square_crop(img)
    np.testing.assert_array_equal(got, want)
    got_t = tv.smart_square_crop(torch.from_numpy(img))
    np.testing.assert_array_equal(got_t.numpy(), want)


# ------------------------------------------------------------------ reader
def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


@pytest.mark.parametrize("name", ["clip_80x60.avi", "odd_59x80.avi"])
def test_reader_equals_videocapture_on_the_small_clips(name):
    video = avi.read_avi(_clip(name))
    frames, fps = _cv2_frames(_clip(name))
    entry = MANIFEST["clips"][name]
    assert len(video) == len(frames) == entry["frames"]
    assert video.fps == fps == entry["fps"]
    assert (video.height, video.width) == frames[0].shape[:2]
    for i, want in enumerate(frames):
        got = video.frame(i)
        np.testing.assert_array_equal(got, want)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"][i]


def test_reader_equals_videocapture_on_the_720p_clip():
    """Three of its 40 frames (a frame decodes in ~0.3 s); the card's
    phase holds all 40 to the manifest's hashes."""
    name = "print_720p.avi"
    video = avi.read_avi(_clip(name))
    entry = MANIFEST["clips"][name]
    assert (len(video), video.fps) == (entry["frames"], entry["fps"])
    assert (video.width, video.height) == (1280, 720)
    for i in (0, 20):
        png = cv2.imread(_clip(f"print_720p_f{i}.png"))
        got = video.frame(i)
        np.testing.assert_array_equal(got, png)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"][i]
    cap = cv2.VideoCapture(_clip(name))
    cap.set(cv2.CAP_PROP_POS_FRAMES, 39)
    ok, want = cap.read()
    cap.release()
    np.testing.assert_array_equal(video.frame(39), want)


@pytest.mark.parametrize("kind", ["422", "gray", "rate"])
def test_reader_equals_videocapture_on_written_avis(kind, tmp_path):
    rng = np.random.default_rng(5)
    params = [cv2.IMWRITE_JPEG_QUALITY, 80]
    if kind == "422":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
    imgs = [cv2.GaussianBlur(rng.integers(0, 256, (48, 66, 3), np.uint8),
                             (3, 3), 0) for _ in range(3)]
    if kind == "gray":
        imgs = [cv2.cvtColor(i, cv2.COLOR_BGR2GRAY) for i in imgs]
    jpegs = [cv2.imencode(".jpg", i, params)[1].tobytes() for i in imgs]
    path = str(tmp_path / f"{kind}.avi")
    rate, scale = (30000, 1001) if kind == "rate" else (25, 1)
    fx.write_avi(path, jpegs, 66, 48, rate=rate, scale=scale)
    video = avi.read_avi(path)
    frames, fps = _cv2_frames(path)
    assert len(video) == len(frames) == 3
    assert video.fps == pytest.approx(fps, rel=1e-12)
    for i, want in enumerate(frames):
        np.testing.assert_array_equal(video.frame(i), want)


def test_reader_refuses_other_codecs_and_containers(tmp_path):
    jpeg = cv2.imencode(".jpg", np.zeros((16, 16, 3), np.uint8))[1].tobytes()
    path = str(tmp_path / "h264.avi")
    fx.write_avi(path, [jpeg], 16, 16, fourcc=b"H264")
    with pytest.raises(ValueError, match="H264, not MJPEG or MPEG-4"):
        avi.read_avi(path)
    with open(MPEG4_CLIP, "rb") as f:                 # an H.264 sample entry
        mp4 = f.read()
    at = mp4.index(b"mp4v")
    avc = tmp_path / "v.mp4"
    avc.write_bytes(mp4[:at] + b"avc1" + mp4[at + 4:])
    with pytest.raises(ValueError, match="H.264"):
        tv.open_video(str(avc))
    with pytest.raises(ValueError, match="could not open video"):
        tv.create_hr_lr_images_from_video(str(avc), str(tmp_path / "h"),
                                          str(tmp_path / "l"), device="cpu")
    mkv = tmp_path / "v.mkv"
    mkv.write_bytes(b"\x1aE\xdf\xa3" + bytes(28))
    with pytest.raises(ValueError, match="Matroska"):
        tv.open_video(str(mkv))
    for codec, name in (("V_MPEG4/ISO/AVC", "H.264"),
                        ("V_MPEGH/ISO/HEVC", "HEVC"), ("V_AV1", "AV1"),
                        ("V_VP9", "VP9"), ("V_FFV1", "FFV1")):
        mkv.write_bytes(mkv_file(codec, 16, 16, [jpeg],
                                 default_duration=40000000))
        with pytest.raises(ValueError,
                           match=f"Matroska/WebM file with {name}"):
            tv.open_video(str(mkv))
    with pytest.raises(ValueError, match="could not open video"):
        tv.create_hr_lr_images_from_video(str(mkv), str(tmp_path / "h"),
                                          str(tmp_path / "l"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tv.create_hr_lr_images_from_video(str(tmp_path / "missing.avi"),
                                          "h", "l", device="cpu")


def test_reader_refuses_frames_ffmpeg_converts_on_another_path():
    img = np.zeros((16, 16, 3), np.uint8)
    for params, match in (([cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], "4:2:0"),
                          ([], None)):
        body = cv2.imencode(".jpg", img if match else img[:15], params)[1]
        with pytest.raises(ValueError, match=match or "odd height"):
            avi.decode_mjpeg_frame(body.tobytes())


def test_simple_idct_dc_only_rows_take_the_shortcut():
    """A DC-only row is DC << 3 (not the general formula's rounding), so a
    flat block at the top of the range lands where FFmpeg puts it."""
    block = np.zeros((8, 8), np.int64)
    block[0, 0] = 2000 + 1024
    flat = avi.simple_idct(block)
    assert (flat == flat[0, 0]).all() and flat[0, 0] == 255
    block[0, 0] = 1024 - 64
    assert (avi.simple_idct(block) == 120).all()


# --------------------------------------------------------------- extractor
def _jax_draws_fn(seed):
    """JAX's draws for each written frame: ``key, sub = split(key)``."""
    state = {"key": jax.random.PRNGKey(seed)}

    def fn(shape):
        state["key"], sub = jax.random.split(state["key"])
        return jax_draws(sub, shape)

    return fn


def _assert_same_outputs(jdir, tdir, names):
    for sub in ("HR", "LR"):
        for n in names:
            want = cv2.imread(os.path.join(jdir, sub, n))
            got = cv2.imread(os.path.join(tdir, sub, n))
            np.testing.assert_array_equal(got, want, err_msg=f"{sub}/{n}")


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name,first", [("clip_80x60.avi", 3),
                                        ("pan_96x64.mp4", 2)])
def test_extractor_on_jax_draws_equals_jax(name, first, tmp_path):
    """The training variant with ``hr_size`` (cv2's INTER_AREA), then a
    second run into the same directories that continues the numbering; on
    the MJPEG AVI the port is fed cv2's frames, on the MPEG-4 MP4 it reads
    the clip with its own reader."""
    clip = _clip(name)
    frames, fps = _cv2_frames(clip)
    if name.endswith(".mp4"):
        video = tv.open_video(clip)
        frames, fps = video.frames, video.fps
    else:
        frames = (lambda f=frames: f)
    for run, kw in enumerate(({}, {"skip_seconds": 1.0, "max_frames": 1})):
        out = {}
        for pkg in ("jax", "torch"):
            root = str(tmp_path / pkg)
            args = dict(hr_dir=os.path.join(root, "HR"),
                        lr_dir=os.path.join(root, "LR"), hr_size=48,
                        interpolation_map_path=os.path.join(root, "imap.pkl"),
                        class_labels_map_path=os.path.join(root, "cmap.pkl"),
                        class_id=1, seed=3 + run, **kw)
            if pkg == "jax":
                out[pkg] = jv.create_hr_lr_images_from_video(clip, **args)
            else:
                out[pkg] = tv.create_hr_lr_images_from_frames(
                    frames(), fps, device="cpu",
                    draws_fn=_jax_draws_fn(3 + run), **args)
        assert out["torch"] == out["jax"]
        assert len(out["jax"]) == (first if run == 0 else 1)
        _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "torch"),
                             out["jax"])
    assert out["jax"] == [f"sample_{first:05d}.png"]
    for m in ("imap.pkl", "cmap.pkl"):
        assert _load(str(tmp_path / "torch" / m)) == _load(
            str(tmp_path / "jax" / m))


@pytest.mark.parametrize("name,side", [("odd_59x80.avi", 58),
                                       ("pan_96x64.mp4", 64)])
def test_prediction_variant_on_jax_draws_equals_jax(name, side, tmp_path):
    """Cell 5's variant without ``hr_size``: on the odd-width clip the 59^2
    crop is trimmed to 58^2; the port reads each clip with its own
    reader."""
    clip = _clip(name)
    video = tv.open_video(clip)
    out = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)
        args = dict(hr_dir=os.path.join(root, "HR"),
                    lr_dir=os.path.join(root, "LR"), class_id=2,
                    predictions_class_map_path=os.path.join(root, "p.pkl"),
                    frame_interval_seconds=0.5, seed=5)
        if pkg == "jax":
            out[pkg] = jv.create_hr_lr_prediction_images_from_video(clip, **args)
        else:
            out[pkg] = tv.create_hr_lr_images_from_frames(
                video.frames(), video.fps, hr_dir=args["hr_dir"],
                lr_dir=args["lr_dir"], frame_interval_seconds=0.5,
                class_labels_map_path=args["predictions_class_map_path"],
                class_id=2, device="cpu", draws_fn=_jax_draws_fn(5))
    assert out["torch"] == out["jax"] and len(out["jax"]) == 4
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "torch"),
                         out["jax"])
    hr = cv2.imread(str(tmp_path / "torch" / "HR" / out["jax"][0]))
    assert hr.shape == (side, side, 3)
    assert _load(str(tmp_path / "torch" / "p.pkl")) == _load(
        str(tmp_path / "jax" / "p.pkl")) == {n: 2 for n in out["jax"]}
    assert not os.path.exists(str(tmp_path / "torch" / "imap.pkl"))


def test_the_video_entry_point_seeds_its_generator(tmp_path):
    clip = _clip("clip_80x60.avi")
    runs = []
    for k in range(2):
        root = tmp_path / str(k)
        runs.append(tv.create_hr_lr_images_from_video(
            clip, str(root / "HR"), str(root / "LR"), hr_size=32, seed=7,
            interpolation_map_path=str(root / "m.pkl"), device="cpu",
            max_frames=2))
    assert runs[0] == runs[1] == ["sample_00000.png", "sample_00001.png"]
    for n in runs[0]:
        a = cv2.imread(str(tmp_path / "0" / "LR" / n))
        b = cv2.imread(str(tmp_path / "1" / "LR" / n))
        np.testing.assert_array_equal(a, b)
        assert a.shape == (16, 16, 3)


# ------------------------------------------------------------ the commands
@pytest.mark.parametrize("name,pairs", [("clip_80x60.avi", 3),
                                        ("pan_96x64.mp4", 2)])
def test_preprocess_through_both_command_lines(name, pairs, tmp_path, capsys):
    """The same files, HR and LR pixels, interpolation map and class map
    from both commands: the port draws JAX's degradations from the seed."""
    clip = _clip(name)
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
    assert sorted(os.listdir(tmp_path / "torch" / "LR")) == names
    for n in names:
        for d in ("HR", "LR"):
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "torch" / d / n)),
                cv2.imread(str(tmp_path / "jax" / d / n)))
        assert cv2.imread(str(tmp_path / "torch" / "LR" / n)).shape == (16, 16, 3)
    m_t, m_j = (_load(str(tmp_path / p / "m.pkl")) for p in ("torch", "jax"))
    assert m_t == m_j and set(m_t.values()) <= set(
        ("INTER_LINEAR", "INTER_CUBIC", "INTER_AREA", "INTER_LANCZOS4"))
    assert _load(str(tmp_path / "torch" / "c.pkl")) == _load(
        str(tmp_path / "jax" / "c.pkl"))


def test_preprocess_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(["preprocess", "--video", _clip("clip_80x60.avi"),
                   "--hr-dir", str(tmp_path / "h"), "--lr-dir",
                   str(tmp_path / "l")])
    assert not (tmp_path / "h").exists()


def test_a_value_rounded_apart_moves_the_round_trip_inside_its_cover():
    """``chip_smoke._mcu_cover``, which bounds where the card's LR may
    differ from the CPU's after the JPEG stage: one uint8 value changed
    moves the decoded image only inside its 16x16 MCU and one pixel
    around it."""
    import chip_smoke
    from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
    from tpusr_torch.pipeline.jpeg_encode import encode_jpeg_u8

    rng = np.random.default_rng(11)
    img = cv2.GaussianBlur(rng.integers(0, 256, (64, 80, 3), np.uint8), (5, 5), 0)
    base = decode_jpeg_u8(encode_jpeg_u8(img, 40))
    for y, x in ((17, 31), (0, 0), (47, 79), (32, 16)):
        other = img.copy()
        other[y, x, 1] ^= 1
        moved = (decode_jpeg_u8(encode_jpeg_u8(other, 40)) != base).any(-1)
        diff = np.zeros(img.shape[:2], bool)
        diff[y, x] = True
        cover = chip_smoke._mcu_cover(diff)
        assert not (moved & ~cover).any(), (y, x)
        assert cover.sum() <= 18 * 18
