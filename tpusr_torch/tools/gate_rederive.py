"""Re-derive a gate report's cascade rows offline from its stored raw votes
(port of ``tpusr/tools/gate_rederive.py``, for the port's gate reports).

``serving_gate`` stores every run's per-image votes (``raw_votes``: class +
confidence per mode, plus the shared-trunk ranking scores) precisely so the
analytically derived rows — cascade thresholds, static top-K fractions, the
rank analysis — can be recomputed WITHOUT re-training. This tool replaces a
report's derived ``cascade_int8*`` rows with rows for the CURRENT
``CASCADE_THRESHOLDS`` / ``CASCADE_FRACS`` (e.g. after the sweep is widened),
refreshes ``cascade_rank_analysis``, and recomputes the aggregate.

Safety: eval labels are not stored in gate reports, but the dataset is
seed-deterministic — labels are recovered via the port's ``surface_labels``
(JAX's draws, so a JAX report's labels are the same) and then
CROSS-CHECKED by recomputing every stored (non-derived) mode row's accuracy
from its raw votes; any mismatch aborts the rewrite. A report written
before the port drew JAX's streams fails that check.

Precision note: stored confidences are rounded to 4 decimals. ``vote_frac``
is exact (quantized to 1/n_patches), and the lexicographic tie-break scales
conf by 0.5/n_patches, so a 5e-5 conf rounding error moves the combined
score by <= 2.5e-7 — it can only reorder images whose scores were already
equal to ~4 decimals, the same ties the cascade's stable sort breaks by
index. Derived fractions are therefore reported at the same fidelity the
serving cascade actually has.

Usage:
    python -m tpusr_torch.tools.gate_rederive --in GATE_torch.json \
        --out GATE_torch.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tpusr_torch.tools.serving_gate import (CASCADE_FRACS, CASCADE_PARENTS,
                                            CASCADE_THRESHOLDS, aggregate_runs,
                                            cascade_rank_analysis,
                                            derive_cascade_modes,
                                            surface_labels)


def rederive_run(run: dict) -> dict:
    """Replace one run's derived cascade rows + rank analyses in place
    (every parent pair in serving_gate.CASCADE_PARENTS whose raw votes the
    run carries)."""
    rv = run.get("raw_votes")
    if not rv or not any(t in rv and p in rv
                         for t, p in CASCADE_PARENTS.values()):
        raise ValueError(
            f"seed {run.get('seed')}: raw_votes lacks every cascade parent "
            "pair — cannot re-derive")
    ref_cls = np.asarray(rv["reference"]["cls"])
    ref_conf = np.asarray(rv["reference"]["conf"], np.float64)
    n = ref_cls.size
    # eval labels: seed-deterministic (make_surface_images(seed+1, n))
    labels = surface_labels(run["seed"] + 1, n)

    raw_votes = {name: (np.asarray(v["cls"]), np.asarray(v["conf"],
                                                         np.float64))
                 for name, v in rv.items() if name != "reference"}

    def scores_of(tname):
        if tname in rv and "vote_frac" in rv[tname]:
            return {k: np.asarray(rv[tname][k], np.float64)
                    for k in ("vote_frac", "mean_margin") if k in rv[tname]}
        return None

    # derived-row prefixes, longest first so "bf16_sr_cascade_int8" rows are
    # not misclassified under the "cascade_int8" prefix
    prefixes = sorted(CASCADE_PARENTS, key=len, reverse=True)

    # cross-check: recomputed accuracy must match every stored base row
    kept = []
    for m in run["modes"]:
        if any(m["mode"].startswith(p + c)
               for p in prefixes for c in "@["):
            continue  # derived: replaced below
        kept.append(m)
        if m["mode"] in raw_votes:
            acc = float((raw_votes[m["mode"]][0] == labels).mean())
            if abs(acc - m["accuracy"]) > 1e-9:
                raise ValueError(
                    f"seed {run['seed']} mode {m['mode']!r}: recomputed "
                    f"accuracy {acc} != stored {m['accuracy']} — label "
                    "recovery failed, refusing to rewrite")
    n_patches = run["protocol"].get("patches_per_image") or 100
    derived = []
    for prefix, (tname, pname) in CASCADE_PARENTS.items():
        ts = scores_of(tname)
        rows = derive_cascade_modes(raw_votes, ref_cls, ref_conf, labels,
                                    trunk_scores=ts, n_patches=n_patches,
                                    parents=(tname, pname), prefix=prefix)
        derived.extend(rows)
        rank = cascade_rank_analysis(raw_votes, ref_cls, ts, n_patches,
                                     trunk_mode=tname)
        if rank is not None:
            key = ("cascade_rank_analysis" if prefix == "cascade_int8"
                   else f"{prefix}_rank_analysis")
            run[key] = rank
    bfpsnr = run.get("psnr_bf16_sr_vs_f32_sr_db")
    for m in derived:
        m["passes_gate"] = m["vote_agreement"] >= 0.99
        if m["mode"].startswith("bf16_sr_cascade") and bfpsnr is not None:
            m["sr_psnr_vs_f32_db"] = bfpsnr  # the SR image these rows serve
            m["image_faithful"] = bfpsnr >= 35.0
    run["modes"] = kept + derived
    return run


def rederive_report(report: dict) -> dict:
    for run in report["runs"]:
        rederive_run(run)
    report["aggregate"] = aggregate_runs(report["runs"])
    report.setdefault("rederived", []).append({
        "cascade_thresholds": list(CASCADE_THRESHOLDS),
        "cascade_fracs": list(CASCADE_FRACS),
        "note": "derived cascade rows recomputed offline from raw_votes "
                "(tpusr_torch.tools.gate_rederive); labels recovered "
                "seed-deterministically and cross-checked against every "
                "stored mode row's accuracy",
    })
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        report = json.load(f)
    report = rederive_report(report)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    agg = {m["mode"]: (m["min_vote_agreement"], m["total_flips"],
                       m["passes_gate_all_seeds"])
           for m in report["aggregate"]["modes"]}
    print(json.dumps(agg, indent=2))


if __name__ == "__main__":
    main()
