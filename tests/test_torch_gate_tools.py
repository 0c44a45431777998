"""The port's gate tools (tpusr_torch/tools/gate_merge.py, gate_rederive.py)
against tpusr/tools/gate_merge.py and gate_rederive.py on the same report
fixtures, and the port's ``gate_rederive`` on a report written by the
port's own ``run_gate``."""

import copy
import functools
import json

import numpy as np
import pytest
import torch

import tpusr.tools.gate_merge as jmerge
import tpusr.tools.gate_rederive as jrederive
import tpusr.tools.serving_gate as jsg
import tpusr_torch.tools.gate_merge as tmerge
import tpusr_torch.tools.gate_rederive as trederive
import tpusr_torch.tools.serving_gate as tsg
from test_torch_gate import threads_per_worker  # noqa: F401

N = 24
# the provenance notes name each tool's own module
NOTES = {"merged_from", "rederived"}


def _run(seed: int, drop_fracs=()) -> dict:
    """A gate run as run_gate writes it, from random votes, with the eval
    labels of the port's ``surface_labels(seed + 1, N)``; the derived rows
    of ``drop_fracs`` are left out (an older sweep)."""
    rng = np.random.default_rng(seed)
    labels = tsg.surface_labels(seed + 1, N)
    ref_cls = np.where(rng.random(N) < 0.85, labels, 1 - labels)
    ref_conf = np.round(rng.uniform(0.5, 1.0, N), 4)
    votes, scores = {}, {}
    for name, flip in (("int8_per_patch", 0.02), ("shared_trunk_int8", 0.2),
                       ("bf16_sr_per_patch_int8", 0.05),
                       ("bf16_sr_shared_trunk_int8", 0.25),
                       ("shared_trunk_f32", 0.1)):
        cls = np.where(rng.random(N) < flip, 1 - ref_cls, ref_cls)
        votes[name] = (cls, np.round(rng.uniform(0.5, 1.0, N), 4))
        if "shared_trunk_int8" in name:
            scores[name] = {"vote_frac": rng.integers(50, 101, N) / 100.0,
                            "mean_margin": np.round(rng.uniform(0, 1, N), 4)}
    modes = [tsg._compare(name, ref_cls, ref_conf, *v, labels)
             for name, v in votes.items()]
    run = {"protocol": {"images": N, "size": 512, "patch": 96, "stride": 48,
                        "patches_per_image": 100},
           "training": {"clf_steps": 500, "edsr_steps": 600,
                        "clf_final_train_acc": 1.0},
           "seed": seed,
           "reference_accuracy": float((ref_cls == labels).mean()),
           "reference_boundary_images": int((ref_conf < 0.65).sum()),
           "psnr_bf16_sr_vs_f32_sr_db": 45.5, "modes": modes}
    for prefix, (tname, pname) in tsg.CASCADE_PARENTS.items():
        rows = tsg.derive_cascade_modes(votes, ref_cls, ref_conf, labels,
                                        trunk_scores=scores[tname],
                                        parents=(tname, pname), prefix=prefix)
        run["modes"] += [r for r in rows
                         if not any(f"@frac={f}" in r["mode"]
                                    for f in drop_fracs)]
        key = ("cascade_rank_analysis" if prefix == "cascade_int8"
               else f"{prefix}_rank_analysis")
        run[key] = tsg.cascade_rank_analysis(votes, ref_cls, scores[tname],
                                             trunk_mode=tname)
    for m in run["modes"]:
        m["passes_gate"] = m["vote_agreement"] >= 0.99
        if m["mode"].startswith("bf16_sr"):
            m["sr_psnr_vs_f32_db"] = run["psnr_bf16_sr_vs_f32_sr_db"]
            m["image_faithful"] = True
    run["raw_votes"] = {
        "reference": {"cls": ref_cls.tolist(), "conf": ref_conf.tolist()},
        **{name: {"cls": c.tolist(), "conf": f.tolist(),
                  **{k: v.tolist() for k, v in scores.get(name, {}).items()}}
           for name, (c, f) in votes.items()}}
    return run


def _report(seeds, drop_fracs=()):
    runs = [_run(s, drop_fracs) for s in seeds]
    return {"task": {"name": "hard"}, "aggregate": tsg.aggregate_runs(runs),
            "runs": runs}


def _without_notes(report):
    return {k: v for k, v in report.items() if k not in NOTES}


@pytest.fixture
def jax_labels_are_the_ports():
    """The port's labels of the fixture are JAX's own: both tools recover
    them from the seed alone."""
    for seed in (1, 2, 3):
        np.testing.assert_array_equal(tsg.surface_labels(seed, N),
                                      jsg.surface_labels(seed, N))


@pytest.mark.parametrize("drop", [(), (0.265625, 0.3046875)])
def test_rederive_equals_jax(jax_labels_are_the_ports, drop):
    report = _report([0, 1], drop)
    got = trederive.rederive_report(copy.deepcopy(report))
    want = jrederive.rederive_report(copy.deepcopy(report))
    assert _without_notes(got) == _without_notes(want)
    assert [{k: v for k, v in r.items() if k != "note"}
            for r in got["rederived"]] == [
        {k: v for k, v in r.items() if k != "note"} for r in want["rederived"]]
    if not drop:     # rows already current: the rewrite changes no row
        assert got["runs"] == report["runs"]
    else:
        assert len(got["runs"][0]["modes"]) > len(report["runs"][0]["modes"])


def test_rederive_refuses_labels_that_do_not_match(monkeypatch):
    monkeypatch.setattr(trederive, "surface_labels",
                        lambda seed, n: 1 - tsg.surface_labels(seed, n))
    with pytest.raises(ValueError, match="label recovery failed"):
        trederive.rederive_report(_report([0]))


def test_merge_reports_equals_jax():
    full = _report([0, 1])
    subset = _report([0, 1])
    for r in full["runs"]:     # the full run lacks the bf16 rows
        r["modes"] = [m for m in r["modes"] if "bf16" not in m["mode"]]
        r["raw_votes"] = {k: v for k, v in r["raw_votes"].items()
                          if "bf16" not in k}
        del r["psnr_bf16_sr_vs_f32_sr_db"]
    got = tmerge.merge_reports(copy.deepcopy(full), copy.deepcopy(subset))
    want = jmerge.merge_reports(copy.deepcopy(full), copy.deepcopy(subset))
    assert _without_notes(got) == _without_notes(want)
    assert got["merged_from"][0]["modes_added"] == want["merged_from"][0][
        "modes_added"] != []
    bad = copy.deepcopy(subset)
    bad["runs"][0]["modes"][0]["flips"] += 1
    for mod in (tmerge, jmerge):
        with pytest.raises(mod.MergeError):
            mod.merge_reports(copy.deepcopy(full), copy.deepcopy(bad))


def test_merge_seed_runs_equals_jax():
    full, extra = _report([0, 1]), _report([1, 2])
    got = tmerge.merge_seed_runs(copy.deepcopy(full), copy.deepcopy(extra))
    want = jmerge.merge_seed_runs(copy.deepcopy(full), copy.deepcopy(extra))
    assert _without_notes(got) == _without_notes(want)
    assert got["merged_from"][0]["seeds_added"] == [2]


def test_cli_output_equals_jax(tmp_path, jax_labels_are_the_ports, capsys):
    src = tmp_path / "in.json"
    src.write_text(json.dumps(_report([0, 1], (0.25,))))
    trederive.main(["--in", str(src), "--out", str(tmp_path / "t.json")])
    jrederive.main(["--in", str(src), "--out", str(tmp_path / "j.json")])
    t, j = (json.loads((tmp_path / f).read_text()) for f in ("t.json", "j.json"))
    assert _without_notes(t) == _without_notes(j)
    sub = tmp_path / "sub.json"
    sub.write_text(json.dumps(_report([2])))
    tmerge.main(["--full", str(tmp_path / "t.json"), "--subset", str(sub),
                 "--out", str(tmp_path / "tm.json"), "--append-seeds"])
    jmerge.main(["--full", str(tmp_path / "j.json"), "--subset", str(sub),
                 "--out", str(tmp_path / "jm.json"), "--append-seeds"])
    t, j = (json.loads((tmp_path / f).read_text()) for f in ("tm.json", "jm.json"))
    assert _without_notes(t) == _without_notes(j)
    assert [r["seed"] for r in t["runs"]] == [0, 1, 2]
    assert "merged 1 new seed runs" in capsys.readouterr().out


def test_rederive_recovers_the_labels_of_a_port_run_gate_report(monkeypatch):
    """A report the port's own run_gate wrote (two training steps of narrow
    networks, the port's own images and labels): gate_rederive recovers its
    eval labels, its cross-check passes, and the derived rows come back as
    they were, but for confidence drifts recomputed from the 4-decimal
    confidences the report stores."""
    monkeypatch.setattr(tsg, "VGG16Classifier", functools.partial(
        tsg.VGG16Classifier, widths=(8, 8, 16, 16, 16)))
    monkeypatch.setattr(tsg, "EDSR", functools.partial(
        tsg.EDSR, num_res_blocks=1, num_filters=8))
    run = tsg.run_gate(n_images=4, size=128, clf_steps=2, edsr_steps=2,
                       verbose=False, mode_names=(
                           "int8_per_patch", "shared_trunk_int8"),
                       device="cpu")
    report = json.loads(json.dumps({"task": {"name": "easy"},
                                    "aggregate": tsg.aggregate_runs([run]),
                                    "runs": [run]}))
    got = trederive.rederive_report(copy.deepcopy(report))
    rows, want = got["runs"][0]["modes"], report["runs"][0]["modes"]
    assert [m["mode"] for m in rows] == [m["mode"] for m in want]
    assert any(m["mode"].startswith("cascade_int8[") for m in rows)
    for a, b in zip(rows, want):
        assert set(a) == set(b), a["mode"]
        for key, v in b.items():
            if "conf_drift" in key:   # from confidences stored to 4 decimals
                assert abs(a[key] - v) <= 1e-4, (a["mode"], key)
            else:
                assert a[key] == v, (a["mode"], key)


def test_gate_main_writes_gate_torch_json_with_the_device(tmp_path,
                                                           monkeypatch):
    """``main``'s flags and report, with ``run_gate`` replaced by fixture
    runs: the default ``--out`` is GATE_torch.json (the JAX package's
    GATE.json stays untouched), the report carries the card's line as
    ``device``, and without a card ``main`` refuses to run."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsg.main(["--seeds", "0"])
    calls = []

    def fake_run_gate(n_images, size, clf_steps, edsr_steps, seed, **kw):
        calls.append((n_images, size, clf_steps, edsr_steps, seed, kw))
        return _run(seed)

    monkeypatch.setattr(tsg, "resolve_device", lambda device: "card")
    monkeypatch.setattr(tsg, "run_gate", fake_run_gate)
    monkeypatch.setattr(tsg, "card_line", lambda dev: f"{dev}, 700.00 W")
    monkeypatch.chdir(tmp_path)
    tsg.main(["--task", "hard", "--seeds", "0,1", "--images", "24",
              "--clf-steps", "5", "--modes", "int8_per_patch"])
    report = json.loads((tmp_path / "GATE_torch.json").read_text())
    assert not (tmp_path / "GATE.json").exists()
    assert report["device"] == "card, 700.00 W"
    assert report["task"] == {"name": "hard", "amp_range": [0.12, 0.25],
                              "noise": 0.01, "coverage_range": [0.35, 1.0]}
    assert [r["seed"] for r in report["runs"]] == [0, 1]
    assert report["aggregate"] == tsg.aggregate_runs(report["runs"])
    assert [c[:5] for c in calls] == [(24, 512, 5, 600, 0), (24, 512, 5, 600, 1)]
    assert calls[0][5]["mode_names"] == ["int8_per_patch"]
    assert calls[0][5]["coverage_range"] == (0.35, 1.0)
    assert calls[0][5]["device"] == "card"
