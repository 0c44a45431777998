"""The port's ``train-esrgan`` against the JAX command: one epoch on the
JAX CLI tests' fixture (4 PNG pairs of 48^2/24^2; generator growth 4 with
1 RRDB and VGG19 at narrow widths in both packages), the same files and
``.meta.json``, eval and history keys (``compare_runs``), and the 5x5
preview PNG of ``--preview-dir`` per epoch."""

import json

from test_torch_cli import narrow_models, train_argv
from test_torch_cli_train import compare_runs, data  # noqa: F401 - fixture

import tpusr.cli.__main__ as jcli
import tpusr_torch.cli.__main__ as tcli
from tpusr_torch.pipeline.png import decode_png


def test_train_esrgan_writes_what_jax_writes(data, tmp_path,  # noqa: F811
                                             monkeypatch):
    narrow_models(monkeypatch)
    argv = train_argv("train-esrgan", data, tmp_path / "jax")
    jcli.main(argv + ["--preview-dir", str(tmp_path / "jprev")])
    path = tcli.main(train_argv("train-esrgan", data, tmp_path / "port")
                     + ["--preview-dir", str(tmp_path / "tprev"),
                        "--device", "cpu"])
    meta = compare_runs(tmp_path / "jax", tmp_path / "port", "train-esrgan")
    assert meta["arch"] == {"scale_factor": 2, "growth_channels": 4,
                            "num_rrdb_blocks": 1}
    assert json.load(open(path + ".meta.json"))["arch"] == meta["arch"]
    for d in ("jprev", "tprev"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == [
            "epoch_001_sr_grid.png"]
    grid = decode_png((tmp_path / "tprev" / "epoch_001_sr_grid.png").read_bytes())
    assert grid.shape == (5 * 48, 5 * 48, 3)
