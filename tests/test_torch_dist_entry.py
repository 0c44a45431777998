"""The port's multi-rank dry run (``tpusr_torch.entry.dryrun_multichip``,
the counterpart of ``__graft_entry__.dryrun_multichip``) on 2 and 4 gloo
ranks on the CPU, the 2-process bootstrap (tests/test_bootstrap.py's
checks), and ``train-edsr --data-parallel`` under
``python -m torch.distributed.run --nproc-per-node 2``.

Each check of the dry run holds its sharded result equal to the same call
unsharded (classes equal, losses within 1e-5 relative, TP within 1e-4, the
full-image SR within 5e-5) and raises otherwise.
"""

import glob
import json
import os
import subprocess
import sys

import pytest

from test_torch_data import _write_pairs
from tpusr_torch.dist import bootstrap
from tpusr_torch.entry import dryrun_bootstrap_2proc, dryrun_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu_ranks(n, capfd):
    dryrun_multichip(n, device="cpu")
    out = capfd.readouterr().out
    assert f"dryrun_multichip({n}):" in out and "single==multi OK" in out
    assert "sp_full_image_sr_maxerr" in out and "pp_loss" in out
    assert "bootstrap 2-process" in out and "OK" in out


def test_two_process_mesh_psum_and_dp_step():
    res = dryrun_bootstrap_2proc("cpu")
    # 4 rows x 2 cols of 1.0 from process 0 + of 2.0 from process 1
    assert res["psum_total"] == 24.0
    assert res["dp_loss"] == pytest.approx(res["single_loss"], rel=1e-5)
    assert res["mesh_2d"] == [1, 2]
    assert res["hybrid"] == [1, 2]        # one node of 2 ranks
    assert "!= 2 ranks" in res["bad_shape"]


def test_single_process_initialize_is_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert bootstrap.initialize(device="cpu") is False  # no address: no-op
    assert not bootstrap.is_initialized()
    with pytest.raises(ValueError, match="coordinator address"):
        bootstrap.initialize(num_processes=2, device="cpu")


def _train_edsr(data, out, *launcher, extra=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [*launcher, "-m", "tpusr_torch.cli", "train-edsr",
           "--hr-dir", str(data / "HR"), "--lr-dir", str(data / "LR"),
           "--out", str(out), "--epochs", "1", "--batch-size", "8",
           "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metas = glob.glob(str(out / "*.meta.json"))
    assert len(metas) == 1, metas          # one checkpoint, from rank 0
    assert len(glob.glob(str(out / "EDSR_x2_*"))) == 4   # + jsonl, csv
    with open(metas[0]) as f:
        return json.load(f)


def test_train_edsr_data_parallel_under_torchrun(tmp_path):
    """2 ranks, each a process of torchrun: the 4-pair fixture's run gives
    the loss of the run without --data-parallel. The rendezvous store and
    the ranks' MASTER_ADDR are on 127.0.0.1 (``--standalone`` would take
    ``localhost`` and ``socket.getfqdn()``: name lookups, which a machine
    without a network may answer late or not at all)."""
    (tmp_path / "ds").mkdir()
    data = _write_pairs(tmp_path / "ds")
    dp = _train_edsr(data, tmp_path / "dp", sys.executable, "-m",
                     "torch.distributed.run", "--nproc-per-node", "2",
                     "--rdzv-backend", "c10d", "--rdzv-endpoint",
                     "127.0.0.1:0", "--local-addr", "127.0.0.1",
                     extra=("--data-parallel",))
    single = _train_edsr(data, tmp_path / "single", sys.executable)
    for k in ("loss", "val_loss"):
        assert dp["history"][k] == pytest.approx(single["history"][k],
                                                 rel=1e-5)
    assert dp["eval"]["loss"] == pytest.approx(single["eval"]["loss"],
                                               rel=1e-5)
