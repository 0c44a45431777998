"""The port's command line (``tpusr_torch/cli/__main__.py``) against the JAX
package's (``tpusr/cli/__main__.py``) on the CPU (``--device cpu``).

- ``_split`` equals scikit-learn's ``train_test_split`` indices exactly;
- the parser lists the JAX command set, with every JAX flag and default;
- ``classic`` writes the JAX command's ``classic_summary.json`` keys, the
  quality metrics at rtol 1e-4, their variances over the pairs within what
  moving each value by that much can change (time and memory are
  measurements of each run, not compared);
- ``pipeline`` on the same weights (JAX facades' checkpoints carried to the
  port by ``tpusr_torch/bridge.py``): the same keys and predictions,
  confidences and PSNR/SSIM within 1e-4;
- the port's own chain ``train-*`` -> ``pipeline`` on the trained
  checkpoints, ``--resume`` continuing Adam's step count, and the commands
  that exit with a message (no card, ``--vgg19-weights``, ``preprocess``,
  ``convert``);
- ``eda`` writes the JAX command's ``eda_metrics.csv`` and
  ``eda_summary.csv`` (numerically at rtol 1e-4, LPIPS within 1e-5, on the
  same LPIPS npz), and the loaders read baseline JPEG pairs as the JAX
  loaders read them with cv2, bit for bit.

The data is the JAX CLI tests' fixture: 4 HR/LR PNG pairs of 48^2/24^2.
The networks are narrowed in both packages (``narrow_models``).
"""

import argparse
import functools
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import tpusr.cli.__main__ as jcli
import tpusr_torch.cli.__main__ as tcli
from test_torch_data import RESIZE_ATOL, _write_pairs
from test_torch_fixtures import NARROW_WIDTHS

RTOL = 1e-4
TRAIN_COMMANDS = ("train-srcnn", "train-edsr", "train-esrgan", "train-vgg16")
RUN_COMMANDS = (*TRAIN_COMMANDS, "classic", "pipeline")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_pairs(tmp_path_factory.mktemp("cli_ds"))


def narrow_models(mp):
    """EDSR 1 block of 8 filters, ESRGAN growth 4 with 1 RRDB, VGG16 and
    VGG19 at ``NARROW_WIDTHS``, in both packages' commands and facades."""
    import tpusr.config as jcfg
    import tpusr.models.vgg as jvgg
    import tpusr_torch.config as tcfg
    import tpusr_torch.models.api as tapi
    import tpusr_torch.models.vgg as tvgg

    for cfg in (jcfg, tcfg):
        mp.setattr(cfg, "EDSRConfig", functools.partial(
            cfg.EDSRConfig, num_res_blocks=1, num_filters=8))
        mp.setattr(cfg, "ESRGANConfig", functools.partial(
            cfg.ESRGANConfig, growth_channels=4, num_rrdb_blocks=1))
    for name in ("_VGG16_CFG", "_VGG19_CFG"):
        mp.setattr(jvgg, name, tuple((b, n, w) for (b, n, _f), w in
                                     zip(getattr(jvgg, name), NARROW_WIDTHS)))
    for name in ("VGG16Classifier", "VGG19Features"):
        narrow = functools.partial(getattr(tvgg, name), widths=NARROW_WIDTHS)
        mp.setattr(tvgg, name, narrow)
        mp.setattr(tapi, name, narrow)


def no_jax_figures(mp):
    """The JAX commands' matplotlib figures replaced by no-ops (the port
    draws none)."""
    import tpusr.viz as jviz

    for name in dir(jviz):
        if name.startswith(("plot_", "show_")):
            mp.setattr(jviz, name, lambda *a, **k: None)


def train_argv(cmd, data, out, epochs=1):
    if cmd == "train-vgg16":
        return [cmd, "--hr-dir", str(data / "HR"), "--class-map",
                str(data / "cmap.pkl"), "--out", str(out), "--epochs",
                str(epochs), "--batch-size", "8", "--patch-size", "32",
                "--stride", "16"]
    argv = [cmd, "--hr-dir", str(data / "HR"), "--lr-dir", str(data / "LR"),
            "--out", str(out), "--epochs", str(epochs), "--batch-size", "8"]
    if cmd == "train-srcnn":
        argv += ["--interp-map", str(data / "imap.pkl")]
    return argv


# ---------------------------------------------------------------- _split

@pytest.mark.parametrize("n", [3, 5, 8, 10, 16, 33, 100, 1120, 1296, 1600])
def test_split_equals_sklearn(n):
    x = np.arange(n) * 3
    y = np.arange(n) % 2
    got = tcli._split(x, y)
    want = jcli._split(x, y)      # sklearn's train_test_split, twice
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n_te = math.ceil(0.2 * n)
    assert len(got[4]) == n_te and len(got[2]) == math.ceil(
        0.1 / 0.8 * (n - n_te))


def test_split_keeps_rows_of_arrays_together():
    x = np.random.default_rng(0).random((40, 3, 3, 2)).astype(np.float32)
    y = np.arange(40)
    x_tr, y_tr, x_va, y_va, x_te, y_te = tcli._split(x, y)
    for xs, ys in ((x_tr, y_tr), (x_va, y_va), (x_te, y_te)):
        np.testing.assert_array_equal(xs, x[ys])
    assert sorted(np.concatenate([y_tr, y_va, y_te]).tolist()) == list(range(40))


# --------------------------------------------------------------- parser

def _subparsers(parser):
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def test_help_lists_the_jax_command_set(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    names = list(_subparsers(jcli.build_parser()))
    assert len(names) == 10
    assert list(_subparsers(tcli.build_parser())) == names
    assert "{" + ",".join(names) + "}" in out


@pytest.mark.parametrize("cmd", list(_subparsers(jcli.build_parser())))
def test_each_command_takes_the_jax_flags_and_defaults(cmd):
    def flags(sp):
        return {a.dest: (tuple(a.option_strings), a.default, a.required)
                for a in sp._actions if a.dest != "help"}

    want = flags(_subparsers(jcli.build_parser())[cmd])
    got = flags(_subparsers(tcli.build_parser())[cmd])
    assert {k: v for k, v in got.items() if k != "device"} == want
    if cmd in RUN_COMMANDS + ("serve",):
        assert got["device"] == (("--device",), "cuda", False)


def test_module_entry_runs_help():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "tpusr_torch.cli",
                          "train-edsr", "--help"], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--hr-dir" in out.stdout


# ---------------------------------------------------------------- exits

def _argv(cmd, data, tmp_path):
    if cmd in TRAIN_COMMANDS:
        return train_argv(cmd, data, tmp_path / "o")
    if cmd == "classic":
        return [cmd, "--hr-dir", str(data / "HR"), "--lr-dir",
                str(data / "LR"), "--out", str(tmp_path / "o")]
    return [cmd, "--lr-dir", str(data / "LR"), "--hr-dir", str(data / "HR"),
            "--class-map", str(data / "cmap.pkl"), "--out", str(tmp_path / "o")]


@pytest.mark.parametrize("cmd", RUN_COMMANDS)
def test_a_command_refuses_to_run_without_a_card(data, tmp_path, monkeypatch,
                                                 cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(_argv(cmd, data, tmp_path))
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("argv,match", [
    (["preprocess", "--video", "v.mp4", "--hr-dir", "h", "--lr-dir", "l"],
     "video decoder"),
    (["convert", "--model", "esrgan", "--src", "ckpt", "--disc", "d.h5"],
     "--disc only applies"),
], ids=["preprocess", "convert"])
def test_commands_not_ported_exit_naming_what_they_lack(argv, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv)


@pytest.mark.parametrize("cmd", TRAIN_COMMANDS)
def test_data_parallel_exits_naming_item_8(data, tmp_path, cmd, monkeypatch):
    """--data-parallel is ported: in one process it trains over a world-1
    mesh and writes the command's checkpoint (its loss equal to the run
    without it over 2 ranks under torchrun: tests/test_torch_dist_entry.py;
    the trainers' DP steps equal to unsharded ones:
    tests/test_torch_dist_sharding.py)."""
    narrow_models(monkeypatch)
    path = tcli.main(train_argv(cmd, data, tmp_path / "dp")
                     + ["--data-parallel", "--device", "cpu"])
    with open(path + ".meta.json") as f:
        ev = json.load(f)["eval"]
    assert ev and all(np.isfinite(v) for v in ev.values()
                      if isinstance(v, float)), ev


def test_vgg19_weights_exit_naming_item_10(data, tmp_path, monkeypatch):
    """``train-esrgan --vgg19-weights`` takes the Keras notop ``.h5``: the
    perceptual VGG19 the trainer gets holds what JAX's loader reads from
    it, and the run equals one on the same weights as a converted
    ``.npz``."""
    import tpusr_torch.train as ttrain
    from tpusr.models.vgg import load_keras_h5_weights as jload_h5
    from test_torch_fixtures import vgg_layers, write_notop_h5

    narrow_models(monkeypatch)
    layers = vgg_layers("vgg19", 7, NARROW_WIDTHS)
    h5 = write_notop_h5(tmp_path / "vgg19_notop.h5", layers)
    npz = str(tmp_path / "vgg19.npz")
    np.savez(npz, **{f"{n}/{k}": a for n, v in layers.items()
                     for k, a in v.items()})
    seen = []

    def trainer(gen, disc, vgg, **kw):
        seen.append({k: v.detach().clone() for k, v in vgg.named_parameters()})
        return real(gen, disc, vgg, **kw)

    real = ttrain.ESRGANTrainer
    monkeypatch.setattr(ttrain, "ESRGANTrainer", trainer)
    evals = []
    for i, weights in enumerate((h5, npz)):
        path = tcli.main(train_argv("train-esrgan", data, tmp_path / f"o{i}")
                         + ["--vgg19-weights", weights, "--device", "cpu"])
        with open(path + ".meta.json") as f:
            evals.append(json.load(f)["eval"])
    assert evals[0] == evals[1]
    template = {"vgg19": {n: {k: np.zeros_like(a) for k, a in v.items()}
                          for n, v in layers.items()}}
    want = jload_h5(template, h5, "vgg19")["vgg19"]
    for n, leaves in want.items():
        np.testing.assert_array_equal(
            seen[0][f"vgg19.{n}.weight"].permute(2, 3, 1, 0).numpy(),
            np.asarray(leaves["kernel"]))
        np.testing.assert_array_equal(seen[0][f"vgg19.{n}.bias"].numpy(),
                                      np.asarray(leaves["bias"]))
    assert all(torch.equal(seen[0][k], seen[1][k]) for k in seen[0])


# -------------------------------------------------------------- classic

def test_classic_summary_equals_jax(data, tmp_path, monkeypatch, capsys):
    no_jax_figures(monkeypatch)
    argv = ["classic", "--hr-dir", str(data / "HR"), "--lr-dir",
            str(data / "LR"), "--fraction", "1.0", "--limit", "3"]
    jcli.main(argv + ["--out", str(tmp_path / "j")])
    tcli.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert "figures are not drawn" in capsys.readouterr().out
    want = json.load(open(tmp_path / "j" / "classic_summary.json"))
    got = json.load(open(tmp_path / "t" / "classic_summary.json"))
    assert sorted(got) == sorted(want) == ["ranked", "summary"]
    assert sorted(got["summary"]) == sorted(want["summary"])
    assert sorted(a for a, _ in got["ranked"]) == sorted(
        a for a, _ in want["ranked"])
    for alg, w in want["summary"].items():
        g = got["summary"][alg]
        assert sorted(g) == sorted(w), alg
        for k, v in w.items():
            if k.startswith(("time_", "memory_")):
                continue
            atol = 0.0
            if k.endswith("_var"):
                # a variance over the pairs of values that agree at rtol:
                # every value moved by d = rtol * |mean| moves it by at most
                # 2 * std * d + d^2 (near-equal values cancel in it)
                d = RTOL * abs(w[k[:-4] + "_mean"])
                atol = 2 * math.sqrt(v) * d + d * d
            np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=atol,
                                       err_msg=f"{alg} {k}")


# ------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def jax_and_port_checkpoints(tmp_path_factory, data):
    """VGG16 (its class-1 bias centred on the bicubic SR so the votes split),
    EDSR x2, SRCNN and ESRGAN x2 (growth 4, 1 RRDB) drawn by the JAX facades
    and saved by them; the same weights carried to the port by ``bridge``
    and saved by the port's facades (ESRGAN's generator; its discriminator,
    which ``pipeline`` does not run, is the port facade's own draw)."""
    import tpusr.models.api as japi
    import tpusr_torch.models.api as tapi
    from test_torch_fixtures import center_classifier_bias
    from tpusr.core.resize import resize as jresize
    from tpusr.models.vgg import VGG16Classifier as JVGG16
    from tpusr_torch.bridge import (edsr_from_flax, esrgan_generator_from_flax,
                                    srcnn_from_flax, vgg16_from_flax)
    from tpusr_torch.data.loading import add_padding, load_predictions_dataset

    d = tmp_path_factory.mktemp("pipe_ck")
    mp = pytest.MonkeyPatch()
    narrow_models(mp)
    try:
        jv = japi.FineTunedVGG16()
        jv.setup_model(input_shape=(96, 96, 3), num_classes=2)
        x_lr, _, _ = load_predictions_dataset(str(data / "LR"),
                                              str(data / "HR"),
                                              str(data / "cmap.pkl"))
        sr = np.clip(np.asarray(jresize(x_lr, (48, 48), "bicubic")), 0, 1)
        patches = np.stack([add_padding(im, 96, 48)[:96, :96] for im in sr])
        params = jax.device_get(jv.state.params)
        probs = JVGG16().apply({"params": params}, patches)
        params = center_classifier_bias(params, np.asarray(probs)[:, None])
        jv.state = jv.state.replace(params=params)
        je = japi.EDSR()
        je.setup_model(scale_factor=2, num_res_blocks=1, num_filters=8)
        js = japi.SRCNNModel()
        js.setup_model()
        jg = japi.ESRGAN()
        jg.setup_model(scale_factor=2, growth_channels=4, num_rrdb_blocks=1)
        jv.trained = je.trained = js._trained = jg.trained = True
        jax_paths = {"vgg16": jv.save(str(d / "jax"), "t"),
                     "edsr": je.save(str(d / "jax"), "t"),
                     "srcnn": js.save(str(d / "jax"), "t"),
                     "esrgan": jg.save(str(d / "jax"), "t")}

        def port_save(facade, module, **kw):
            f = facade(device="cpu")
            f.setup_model(**kw)
            w = dict(module.named_parameters())
            with torch.no_grad():
                for name, p in getattr(f.state, "g_params",
                                       getattr(f.state, "params", None)).items():
                    p.copy_(w[name])
            f.trained = f._trained = True
            return f.save(str(d / "torch"), "t")

        port_paths = {
            "vgg16": port_save(tapi.FineTunedVGG16,
                               vgg16_from_flax(params, device="cpu"),
                               input_shape=(96, 96, 3), num_classes=2),
            "edsr": port_save(tapi.EDSR, edsr_from_flax(
                jax.device_get(je.state.params), 2, device="cpu"),
                scale_factor=2, num_res_blocks=1, num_filters=8),
            "srcnn": port_save(tapi.SRCNNModel, srcnn_from_flax(
                jax.device_get(js.state.params), device="cpu")),
            "esrgan": port_save(tapi.ESRGAN, esrgan_generator_from_flax(
                jax.device_get(jg.state.g_params), device="cpu"),
                scale_factor=2, growth_channels=4, num_rrdb_blocks=1)}
    finally:
        mp.undo()
    return jax_paths, port_paths


def test_pipeline_equals_jax_on_the_same_weights(data, tmp_path, monkeypatch,
                                                 capsys,
                                                 jax_and_port_checkpoints):
    import tpusr.pipeline as jpipe

    narrow_models(monkeypatch)
    no_jax_figures(monkeypatch)
    jax_paths, port_paths = jax_and_port_checkpoints
    jax_results = {}
    jax_run = jpipe.run_defect_detection_comparison

    def keep(*a, **k):
        jax_results.update(jax_run(*a, **k))
        return jax_results
    monkeypatch.setattr(jpipe, "run_defect_detection_comparison", keep)

    base = ["pipeline", "--lr-dir", str(data / "LR"), "--hr-dir",
            str(data / "HR"), "--class-map", str(data / "cmap.pkl"),
            "--batch-size", "3", "--classic-methods",
            "bilinear,bicubic,area,lanczos4,lanczos"]

    def ckpts(paths):
        # both commands read a discriminator path only beside a Keras .h5
        # generator; beside a checkpoint it goes unused in both
        return ["--vgg16-ckpt", paths["vgg16"], "--edsr-ckpt", paths["edsr"],
                "--srcnn-ckpt", paths["srcnn"], "--esrgan-ckpt",
                paths["esrgan"], "--esrgan-disc-ckpt", paths["esrgan"]]

    jcli.main(base + ckpts(jax_paths) + ["--out", str(tmp_path / "j")])
    port = tcli.main(base + ckpts(port_paths)
                     + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "figures are not drawn" in out and "edsr: inference_time_sec" in out
    assert "--esrgan-disc-ckpt" not in out     # no longer a notice: as JAX
    want = json.load(open(tmp_path / "j" / "pipeline_results.json"))
    got = json.load(open(tmp_path / "t" / "pipeline_results.json"))
    assert list(got) == list(want) == ["bilinear", "bicubic", "area",
                                       "lanczos4", "lanczos", "srcnn", "edsr",
                                       "esrgan"]
    split = 0
    for m, w in want.items():
        assert sorted(got[m]) == sorted(w), m
        np.testing.assert_array_equal(port[m]["predictions"],
                                      jax_results[m]["predictions"])
        split += len(set(port[m]["predictions"].tolist())) > 1
        np.testing.assert_allclose(port[m]["confidences"],
                                   jax_results[m]["confidences"], atol=1e-4)
        for k, v in w.items():
            if k == "time_sec":
                continue
            np.testing.assert_allclose(got[m][k], v, rtol=0, atol=1e-4,
                                       err_msg=f"{m} {k}")
    assert split, "no method's classes split: the comparison shows nothing"


# ---------------------------------------------------- the port's chain

@pytest.fixture(scope="module")
def trained(tmp_path_factory, data):
    """Each train command of the port, one epoch on the CPU."""
    d = tmp_path_factory.mktemp("chain")
    mp = pytest.MonkeyPatch()
    narrow_models(mp)
    try:
        paths = {cmd: tcli.main(train_argv(cmd, data, d / cmd)
                                + ["--device", "cpu"])
                 for cmd in TRAIN_COMMANDS}
    finally:
        mp.undo()
    return paths


@pytest.mark.parametrize("cmd", TRAIN_COMMANDS)
def test_train_command_writes_the_jax_files(trained, cmd):
    path = trained[cmd]
    out = os.path.dirname(path)
    name = os.path.basename(path)
    assert sorted(os.listdir(out)) == sorted(
        name + s for s in ("", ".meta.json", ".metrics.csv", ".metrics.jsonl"))
    meta = json.load(open(path + ".meta.json"))
    assert {"eval", "history", "epoch_time_sec", "memory",
            "timestamp"} <= set(meta)
    assert ("arch" in meta) == (cmd != "train-srcnn")
    assert name.startswith({"train-srcnn": "SRCNN_", "train-edsr": "EDSR_x2_",
                            "train-esrgan": "ESRGAN_x2_",
                            "train-vgg16": "VGG16_"}[cmd])


def test_chain_train_commands_to_pipeline(data, tmp_path, monkeypatch,
                                          trained):
    """The reference notebooks' chain: the four train commands' checkpoints
    restore into the pipeline's facades (the frozen-base VGG16's optimizer
    tree into ``FineTunedVGG16``, ESRGAN g4x1 through the ``arch`` the
    port's ``_save_run`` writes) and the comparison runs on them."""
    from tpusr_torch.models.api import FineTunedVGG16
    from tpusr_torch.utils import assert_all_finite

    narrow_models(monkeypatch)
    vgg = FineTunedVGG16(device="cpu")
    vgg.setup_model(input_shape=(96, 96, 3), num_classes=2,
                    from_pretrained=True,
                    pretrained_path=trained["train-vgg16"])
    assert vgg.input_shape == (32, 32, 3)
    assert_all_finite(vgg.state, "vgg16")
    res = tcli.main(["pipeline", "--lr-dir", str(data / "LR"), "--hr-dir",
                     str(data / "HR"), "--class-map", str(data / "cmap.pkl"),
                     "--out", str(tmp_path), "--batch-size", "4",
                     "--classic-methods", "bicubic", "--device", "cpu",
                     "--vgg16-ckpt", trained["train-vgg16"],
                     "--srcnn-ckpt", trained["train-srcnn"],
                     "--edsr-ckpt", trained["train-edsr"],
                     "--esrgan-ckpt", trained["train-esrgan"]])
    got = json.load(open(tmp_path / "pipeline_results.json"))
    assert list(got) == ["bicubic", "srcnn", "edsr", "esrgan"]
    for m, r in got.items():
        assert 0.0 <= r["accuracy"] <= 1.0 and math.isfinite(r["psnr_mean"]), m
        assert res[m]["predictions"].shape == (4,)


def test_resume_continues_the_optimizer_step_count(data, tmp_path,
                                                   monkeypatch):
    narrow_models(monkeypatch)
    argv = train_argv("train-edsr", data, tmp_path / "a") + [
        "--device", "cpu", "--checkpoint-every", "1"]
    first = tcli.main(argv)
    leaves = torch.load(first, weights_only=True)
    steps = leaves["opt_state/count/"]
    assert steps > 0
    assert os.path.exists(tmp_path / "a" / "epoch_0001")
    second = tcli.main(train_argv("train-edsr", data, tmp_path / "a") + [
        "--device", "cpu", "--checkpoint-every", "1", "--resume",
        str(tmp_path / "a" / "epoch_0001")])
    assert torch.load(second, weights_only=True)["opt_state/count/"] == 2 * steps
    # periodic numbering continues from the resumed point's epoch
    assert os.path.exists(tmp_path / "a" / "epoch_0002")



# ------------------------------------------------------------------- eda

def test_eda_command_writes_the_jax_commands_csvs(tmp_path, monkeypatch):
    from test_torch_eda import (JAX_FIGURES, assert_csv_close, random_lpips_npz,
                                write_eda_pairs)
    import tpusr.data.eda as jeda

    root = write_eda_pairs(str(tmp_path / "ds"), n=4)
    npz = random_lpips_npz(tmp_path / "lpips.npz", seed=3)
    # the JAX command sets the variable itself; monkeypatch restores it
    monkeypatch.setenv("TPUSR_LPIPS_WEIGHTS", npz)
    monkeypatch.setattr(jeda, "_lpips_mod", None)
    monkeypatch.setattr(jeda, "_LPIPS_JAX_W", None)
    for name in (*JAX_FIGURES, "save_visual_example"):
        monkeypatch.setattr(jeda, name, lambda *a, **k: None)
    common = ["--hr-dir", os.path.join(root, "HR"), "--lr-dir",
              os.path.join(root, "LR"), "--interp-map",
              os.path.join(root, "imap.pkl"), "--lpips-weights", npz,
              "--limit", "3"]
    jcli.main(["eda", *common, "--out", str(tmp_path / "jax")])
    assert tcli.main(["eda", *common, "--out", str(tmp_path / "port"),
                      "--device", "cpu"]) == str(tmp_path / "port")
    for name in ("eda_metrics.csv", "eda_summary.csv"):
        assert_csv_close(tmp_path / "port" / name, tmp_path / "jax" / name)
    with open(tmp_path / "port" / "eda_metrics.csv") as f:
        assert len(f.read().splitlines()) == 4       # --limit 3 and a header


def test_eda_command_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(["eda", "--hr-dir", "h", "--lr-dir", "l", "--out",
                   str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
    sp = _subparsers(tcli.build_parser())["eda"]
    assert {a.dest: a.default for a in sp._actions}["device"] == "cuda"


def test_loaders_read_baseline_jpeg_pairs_as_jax(tmp_path):
    """The same pairs as JPEG (4:2:0, quality 90): the port's loaders give
    the JAX loaders' arrays bit for bit (the decode equals cv2's)."""
    import pickle

    import cv2

    import tpusr.data.loading as jl
    import tpusr_torch.data.loading as tl

    (tmp_path / "png").mkdir()
    src = _write_pairs(tmp_path / "png")
    for d in ("HR", "LR"):
        (tmp_path / d).mkdir()
        for f in os.listdir(src / d):
            img = cv2.imread(str(src / d / f))
            cv2.imwrite(str(tmp_path / d / f.replace(".png", ".jpg")), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
    with open(src / "cmap.pkl", "rb") as f:
        cmap = {n.replace(".png", ".jpg"): c for n, c in pickle.load(f).items()}
    with open(tmp_path / "cmap.pkl", "wb") as f:
        pickle.dump(cmap, f)
    hr, lr = str(tmp_path / "HR"), str(tmp_path / "LR")
    kw = dict(mode="scale", patch_size=12, stride=6, scale_factor=2)
    for g, w in zip(tl.load_dataset_as_patches(hr, lr, **kw),
                    jl.load_dataset_as_patches(hr, lr, **kw)):
        np.testing.assert_array_equal(g, w)
    # srcnn mode resizes the float LR: within the float resize's tolerance
    kw = dict(mode="srcnn", patch_size=16, stride=8, scale_factor=2)
    gx, gy, *g_hw = tl.load_dataset_as_patches(hr, lr, **kw)
    wx, wy, *w_hw = jl.load_dataset_as_patches(hr, lr, **kw)
    assert g_hw == w_hw
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_allclose(gx, wx, rtol=0, atol=RESIZE_ATOL)
    for g, w in zip(tl.load_predictions_dataset(lr, hr, str(tmp_path / "cmap.pkl")),
                    jl.load_predictions_dataset(lr, hr, str(tmp_path / "cmap.pkl"))):
        np.testing.assert_array_equal(g, w)
