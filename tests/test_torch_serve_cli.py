"""The port's ``serve`` command end to end on the CPU (``--device cpu``), as
``tests/test_serve_cli.py`` drives the JAX command: facade checkpoints ->
CLI -> real HTTP requests against the micro-batching server, in int8 SR +
``per_patch_int8`` calibrated from ``--calib-dir``; and the refusal to run
without a card unless the CPU is asked for."""

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from tpusr_torch.cli.__main__ import build_parser, main
from tpusr_torch.models.api import EDSR as EDSRFacade, FineTunedVGG16
from tpusr_torch.pipeline import png

REPO = Path(__file__).resolve().parent.parent
LR, SCALE, PATCH, STRIDE = 24, 2, 32, 16


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ck")
    edsr = EDSRFacade(device="cpu")
    edsr.setup_model(scale_factor=SCALE, num_res_blocks=1, num_filters=8)
    edsr.trained = True
    edsr_path = edsr.save(str(d), "t")
    vgg = FineTunedVGG16(device="cpu")
    vgg.setup_model(input_shape=(PATCH, PATCH, 3), num_classes=2)
    vgg.trained = True
    vgg_path = vgg.save(str(d), "t")
    return edsr_path, vgg_path


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_cli_http_end_to_end(ckpts, tmp_path):
    edsr_path, vgg_path = ckpts
    port_file = tmp_path / "port"
    calib_dir = tmp_path / "calib"
    calib_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):      # one of another size: resized to the LR size
        side = LR if i else 2 * LR
        (calib_dir / f"c{i}.png").write_bytes(png.encode_png_u8(
            (rng.random((side, side, 3)) * 255).astype(np.uint8)))

    argv = ["serve", "--edsr-ckpt", edsr_path, "--vgg16-ckpt", vgg_path,
            "--scale", str(SCALE), "--lr-size", str(LR),
            "--patch", str(PATCH), "--stride", str(STRIDE),
            "--sr-mode", "int8", "--clf-mode", "per_patch_int8",
            "--calib-dir", str(calib_dir), "--batch-size", "4",
            "--max-wait-ms", "2", "--port", "0",
            "--port-file", str(port_file), "--max-requests", "4",
            "--device", "cpu"]
    err = []

    def run():
        try:
            main(argv)
        except BaseException as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 300
    while not port_file.exists() and time.monotonic() < deadline:
        if err:
            raise err[0]
        time.sleep(0.2)
    assert port_file.exists(), "server never came up"
    base = f"http://127.0.0.1:{port_file.read_text()}"

    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok"
    cfg = health["config"]
    assert (cfg["sr_mode"], cfg["clf_mode"]) == ("int8", "per_patch_int8")
    assert (cfg["lr_h"], cfg["lr_w"], cfg["device"]) == (LR, LR, "cpu")
    assert cfg["batch_size"] == 4 and cfg["border_correction"] is True
    # the port's gate report certifies per_patch_int8 on int8 SR or not;
    # either way the note names it
    assert "int8_sr_per_patch_int8" in cfg["gate"]

    body = png.encode_png(rng.random((LR, LR, 3)))
    # 1: classify
    status, data = _post(base + "/classify", body)
    r = json.loads(data)
    assert status == 200 and r["class"] in (0, 1)
    assert 0.0 <= r["confidence"] <= 1.0
    # 2: sr returns a PNG at HR size
    status, sr_png = _post(base + "/sr", body)
    assert status == 200
    assert png.decode_png_u8(sr_png).shape == (LR * SCALE, LR * SCALE, 3)
    # 3: the combined endpoint
    status, data = _post(base + "/classify_sr", body)
    r3 = json.loads(data)
    assert status == 200 and r3["class"] == r["class"]
    assert base64.b64decode(r3["sr_png_base64"]) == sr_png
    # 4: a bad request -> 400, and the 4th POST ends the server
    status, data = _post(base + "/classify", b"not an image")
    assert status == 400 and "error" in json.loads(data)

    t.join(timeout=120)
    assert not t.is_alive()
    assert not err, err


def test_serve_defaults_are_the_jax_commands():
    from tpusr.cli.__main__ import build_parser as jax_build_parser

    def serve_defaults(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {a.dest: a.default for a in sub.choices["serve"]._actions
                if a.dest != "help"}

    port, jax = serve_defaults(build_parser()), serve_defaults(jax_build_parser())
    assert port.pop("device") == "cuda"
    assert port == jax
    assert (port["sr_mode"], port["clf_mode"], port["cascade_score"],
            port["cascade_frac"], port["cascade_guard"], port["batch_size"],
            port["max_wait_ms"]) == ("f32", "cascade_int8", "vote_frac", 0.25,
                                     0.6, 16, 5.0)


def test_serve_without_a_card_exits_instead_of_running_on_the_cpu(ckpts):
    edsr_path, vgg_path = ckpts
    argv = ["serve", "--edsr-ckpt", edsr_path, "--vgg16-ckpt", vgg_path]
    with pytest.raises(SystemExit) as e:
        main(argv)            # tests/conftest.py hides every CUDA device
    assert e.value.code not in (0, None) and "--device cpu" in str(e.value)
    out = subprocess.run([sys.executable, "-m", "tpusr_torch.cli", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": "-1"})
    assert out.returncode != 0
    assert "--device cpu" in out.stderr


def test_gate_note_reads_the_ports_gate_report():
    from tpusr_torch.cli.__main__ import _gate_certification_note

    args = build_parser().parse_args(["serve", "--edsr-ckpt", "e",
                                      "--vgg16-ckpt", "v"])
    note = _gate_certification_note(args)
    row = "cascade_int8[vote_frac+guard]@frac=0.25"
    report = json.loads((REPO / "GATE_torch.json").read_text())
    modes = report["aggregate"]["modes"]
    m = next(x for x in modes if x["mode"] == row)
    # the report's verdict on the default mode over its seeds (0-11: seed 3
    # fails the bar), and the rows that pass every seed
    assert not m["passes_gate_all_seeds"] and len(m["seeds"]) == 12
    assert note.startswith(f"WARNING: {row} FAILED the hard serving gate "
                           f"(min vote agreement {m['min_vote_agreement']:.4f}")
    passing = [x["mode"] for x in modes if x["passes_gate_all_seeds"]]
    assert passing and note.endswith(", ".join(passing))
    assert "GATE_torch.json" in note and "GATE_r05" not in note
    args.clf_mode, args.sr_mode = "per_patch_f32", "int8"
    assert "int8_sr_f32_per_patch" in _gate_certification_note(args)
    args.clf_mode, args.sr_mode = "shared_trunk_f32", "int8"
    assert _gate_certification_note(args).startswith(
        "WARNING: configuration NOT gate-certified")


def test_calib_dir_reads_its_pngs_beside_files_of_other_formats(tmp_path):
    """``--calib-dir`` reads ``*.png``, ``*.jpg`` and ``*.jpeg`` sorted
    together, as the JAX command lists them, and leaves a file of another
    extension out. The images are read as the JAX command reads them with
    cv2: a JPEG bit for bit, at the LR size exactly, resized with
    ``INTER_AREA`` within one 8-bit level (cv2 rounds a tie up, the port to
    even)."""
    cv2 = pytest.importorskip("cv2")
    from tpusr_torch.cli.__main__ import _read_calib_dir

    rng = np.random.default_rng(3)
    imgs = [(rng.random((side, side, 3)) * 255).astype(np.uint8)
            for side in (LR, 2 * LR)]
    for i, im in enumerate(imgs):
        cv2.imwrite(str(tmp_path / f"c{i}.png"), im[..., ::-1])
    ok, jpg = cv2.imencode(".jpg", imgs[0])
    assert ok
    (tmp_path / "a.jpg").write_bytes(jpg.tobytes())
    (tmp_path / "b.jpeg").write_bytes(jpg.tobytes())
    cv2.imwrite(str(tmp_path / "d.bmp"), imgs[0])
    got = _read_calib_dir(str(tmp_path), (LR, LR))
    assert got.shape == (4, LR, LR, 3) and got.dtype == np.float32
    jpg_rgb = cv2.imdecode(jpg, cv2.IMREAD_COLOR)[..., ::-1]
    for i in (0, 1):      # a.jpg, b.jpeg
        np.testing.assert_array_equal(got[i], jpg_rgb / np.float32(255.0))
    np.testing.assert_array_equal(got[2], imgs[0] / np.float32(255.0))
    want = cv2.resize(imgs[1], (LR, LR), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(got[3] * 255.0, want, atol=1.0 + 1e-4)

    only_bmp = tmp_path / "bmp"
    only_bmp.mkdir()
    cv2.imwrite(str(only_bmp / "a.bmp"), imgs[0])
    with pytest.raises(SystemExit, match="no images"):
        _read_calib_dir(str(only_bmp), (LR, LR))
