"""Merge serving-gate reports from subset ``--modes`` runs into a full one
(port of ``tpusr/tools/gate_merge.py``, for the port's gate reports).

``serving_gate --modes a,b`` re-runs the gate's training + a subset of the
serving modes (plus any analytically derived rows, e.g. the cascade rows,
and the raw per-image votes). Training is seeded and deterministic, so a
subset run at the same (task, seed, images, steps) reproduces the full
run's shared modes EXACTLY — this tool verifies that per seed (vote
agreement, flip count, accuracy must match bit-for-bit; confidence drift to
1e-6) and then grafts the subset run's new mode rows and ``raw_votes`` into
the full artifact, recomputing the aggregate. The result is identical to
what one long full-gate run would have produced, at the cost of only the
subset's modes.

Usage:
    python -m tpusr_torch.tools.gate_merge --full GATE_torch.json \
        --subset GATE_torch_subset.json --out GATE_torch.json
"""

from __future__ import annotations

import argparse
import json

from tpusr_torch.tools.serving_gate import aggregate_runs


class MergeError(ValueError):
    pass


def _check_shared_mode(seed, full_m, sub_m):
    for key in ("vote_agreement", "flips", "accuracy", "boundary_images"):
        if full_m.get(key) != sub_m.get(key):
            raise MergeError(
                f"seed {seed} mode {full_m['mode']!r}: {key} differs between "
                f"runs ({full_m.get(key)} vs {sub_m.get(key)}) — the subset "
                "run did not reproduce the full run")
    for key in ("mean_abs_conf_drift", "max_abs_conf_drift"):
        a, b = full_m.get(key), sub_m.get(key)
        if a is not None and b is not None and abs(a - b) > 1e-6:
            raise MergeError(
                f"seed {seed} mode {full_m['mode']!r}: {key} differs "
                f"({a} vs {b})")


def merge_seed_runs(full: dict, extra: dict) -> dict:
    """Append ``extra``'s runs for seeds the ``full`` report lacks.

    Independent-seed certification accumulates across rounds this way: each
    new-seed run is a complete gate run in itself (own dataset + training +
    mode rows + raw votes), so appending it is exact — no cross-run
    verification is possible or needed beyond task/protocol equality. The
    aggregate is recomputed over all runs; per-mode ``seeds`` lists record
    which seeds support each mode (subset runs give modes uneven support).
    """
    if full.get("task") != extra.get("task"):
        raise MergeError(f"task mismatch: {full.get('task')} vs "
                         f"{extra.get('task')}")
    have = {r["seed"] for r in full["runs"]}
    proto = {k: v for k, v in full["runs"][0]["protocol"].items()}
    added = []
    for r in extra["runs"]:
        if r["seed"] in have:
            continue  # same-seed content merges via merge_reports
        if r["protocol"] != proto:
            raise MergeError(f"seed {r['seed']}: protocol differs from the "
                             f"full report's ({r['protocol']} vs {proto})")
        full["runs"].append(r)
        added.append(r["seed"])
    full["runs"].sort(key=lambda r: r["seed"])
    full["aggregate"] = aggregate_runs(full["runs"])
    full.setdefault("merged_from", []).append({
        "seeds_added": added,
        "note": "independent-seed runs appended "
                "(tpusr_torch.tools.gate_merge --append-seeds)"})
    return full


def merge_reports(full: dict, subset: dict) -> dict:
    """Return ``full`` with ``subset``'s new mode rows + raw votes grafted in.

    Mutates and returns ``full``. Raises MergeError when the two reports
    disagree on task/protocol or on any shared mode's numbers. Seeds present
    only in ``subset`` are ignored here — use merge_seed_runs/--append-seeds
    for those.
    """
    if full.get("task") != subset.get("task"):
        raise MergeError(f"task mismatch: {full.get('task')} vs "
                         f"{subset.get('task')}")
    sub_by_seed = {r["seed"]: r for r in subset["runs"]}
    merged_modes = set()
    for fr in full["runs"]:
        seed = fr["seed"]
        if seed not in sub_by_seed:
            raise MergeError(f"subset run missing seed {seed}")
        sr = sub_by_seed[seed]
        for key in ("protocol", "training"):
            if fr.get(key) != sr.get(key):
                raise MergeError(f"seed {seed}: {key} differs between runs")
        if fr["reference_accuracy"] != sr["reference_accuracy"]:
            raise MergeError(
                f"seed {seed}: reference_accuracy differs "
                f"({fr['reference_accuracy']} vs {sr['reference_accuracy']})")
        full_by_mode = {m["mode"]: m for m in fr["modes"]}
        for sm in sr["modes"]:
            if sm["mode"] in full_by_mode:
                _check_shared_mode(seed, full_by_mode[sm["mode"]], sm)
            else:
                fr["modes"].append(sm)
                merged_modes.add(sm["mode"])
        if "raw_votes" in sr and "raw_votes" not in fr:
            fr["raw_votes"] = sr["raw_votes"]
        elif "raw_votes" in sr:
            # enrich: graft vote entries / per-mode keys (e.g. the trunk's
            # vote_frac ranking scores) the full report lacks; shared keys
            # must agree — same training, same votes
            for mode, votes in sr["raw_votes"].items():
                mine = fr["raw_votes"].setdefault(mode, {})
                for key, val in votes.items():
                    if key not in mine:
                        mine[key] = val
                    elif mine[key] != val:
                        raise MergeError(
                            f"seed {seed}: raw_votes[{mode!r}][{key!r}] "
                            "differs between runs")
        if "gate_standard" in sr and "gate_standard" not in fr:
            fr["gate_standard"] = sr["gate_standard"]
        for key, val in sr.items():
            # graft run-level analyses and SR-drift scalars the full run
            # lacks (e.g. a bf16-modes subset carries
            # psnr_bf16_sr_vs_f32_sr_db and bf16_sr_cascade_int8_rank_
            # analysis that the original full run never computed)
            if val is None or key in ("modes", "raw_votes", "elapsed_sec"):
                continue
            if (key.endswith("rank_analysis") or key.startswith("psnr_")
                    or key.startswith("ssim_")) and fr.get(key) is None:
                fr[key] = val
    full["aggregate"] = aggregate_runs(full["runs"])
    prov = full.setdefault("merged_from", [])
    prov.append({"modes_added": sorted(merged_modes),
                 "subset_task": subset.get("task"),
                 "note": "subset --modes re-run, shared modes verified "
                         "identical per seed (tpusr_torch.tools.gate_merge)"})
    return full


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", required=True)
    ap.add_argument("--subset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--append-seeds", action="store_true",
                    help="append the subset's runs for seeds the full "
                         "report lacks (independent-seed accumulation) "
                         "instead of grafting mode rows into shared seeds")
    args = ap.parse_args(argv)
    with open(args.full) as f:
        full = json.load(f)
    with open(args.subset) as f:
        subset = json.load(f)
    if args.append_seeds:
        merged = merge_seed_runs(full, subset)
        added = merged["merged_from"][-1]["seeds_added"]
        what = f"{len(added)} new seed runs"
    else:
        merged = merge_reports(full, subset)
        added = merged["merged_from"][-1]["modes_added"]
        what = f"{len(added)} new mode rows"
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=2)
    print(f"merged {what} into {args.out}: {added}")


if __name__ == "__main__":
    main()
