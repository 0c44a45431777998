"""The port's ``train-srcnn``, ``train-edsr`` and ``train-vgg16`` against the
JAX commands, each one epoch on the JAX CLI tests' fixture (4 PNG pairs of
48^2/24^2, networks narrowed in both packages): the same files under the
same names, the same ``.meta.json`` keys (the port adds ``arch`` for the
facades, see ``_save_run``), the same eval and history keys, and the same
per-epoch JSONL and CSV columns. The numbers are not compared here (the
trainers are held against JAX's steps in ``tests/test_torch_train.py``,
and from a bare seed in ``tests/test_torch_prng.py``)."""

import csv
import json
import os

import pytest

import tpusr.cli.__main__ as jcli
import tpusr_torch.cli.__main__ as tcli
from test_torch_cli import narrow_models, train_argv
from test_torch_data import _write_pairs
from tpusr_torch.train.logging import read_jsonl


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_pairs(tmp_path_factory.mktemp("train_ds"))


def run_files(out) -> dict:
    """{suffix: path} of one run's files, by what follows the run name."""
    (meta,) = [f for f in os.listdir(out) if f.endswith(".meta.json")]
    name = meta[: -len(".meta.json")]
    files = sorted(os.listdir(out))
    assert all(f.startswith(name) for f in files), files
    return {f[len(name):]: os.path.join(out, f) for f in files}, name


def compare_runs(jax_out, port_out, cmd):
    jf, jname = run_files(jax_out)
    tf, tname = run_files(port_out)
    assert sorted(tf) == sorted(jf) == ["", ".meta.json", ".metrics.csv",
                                       ".metrics.jsonl"]
    prefix = {"train-srcnn": "SRCNN_", "train-edsr": "EDSR_x2_",
              "train-esrgan": "ESRGAN_x2_", "train-vgg16": "VGG16_"}[cmd]
    assert jname.startswith(prefix) and tname.startswith(prefix)
    jm, tm = (json.load(open(f[".meta.json"])) for f in (jf, tf))
    extra = set() if cmd == "train-srcnn" else {"arch"}
    assert set(tm) == set(jm) | extra
    for key in ("eval", "history", "memory"):
        assert sorted(tm[key]) == sorted(jm[key]), key
    assert len(tm["epoch_time_sec"]) == len(jm["epoch_time_sec"]) == 1
    for f in (jf, tf):
        recs = read_jsonl(f[".metrics.jsonl"])
        assert [r["scope"] for r in recs] == ["epoch", "eval"]
    jrecs, trecs = (read_jsonl(f[".metrics.jsonl"]) for f in (jf, tf))
    for a, b in zip(jrecs, trecs):
        assert sorted(a) == sorted(b)
    with open(jf[".metrics.csv"]) as a, open(tf[".metrics.csv"]) as b:
        assert next(csv.reader(a)) == next(csv.reader(b))
    return tm


@pytest.mark.parametrize("cmd", ["train-srcnn", "train-edsr", "train-vgg16"])
def test_train_command_writes_what_jax_writes(data, tmp_path, monkeypatch,
                                              cmd):
    narrow_models(monkeypatch)
    jcli.main(train_argv(cmd, data, tmp_path / "jax"))
    path = tcli.main(train_argv(cmd, data, tmp_path / "port")
                     + ["--device", "cpu"])
    meta = compare_runs(tmp_path / "jax", tmp_path / "port", cmd)
    assert os.path.exists(path)
    if cmd == "train-srcnn":
        assert (meta["eval"]["hr_h"], meta["eval"]["hr_w"]) == (48, 48)
