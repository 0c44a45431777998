"""Compare checkouts of the port on one card: the training step and the
serving gate's time a seed.

For each checkout, in the order given (run old, new, new, old so that drift
on the card shows), two processes run from that checkout: its own
``chip_smoke.py``'s ``[train]`` phase (the EDSR x4 and VGG16 train steps:
medians by CUDA events, device idle share by ``torch.profiler``), then its
serving gate's CLI on one seed of the hard task (``elapsed_sec`` of the
report). The ``[train]`` lines and one line of seconds a seed are printed
with the checkout's label, the card's name and power limit; the whole logs
go to ``chiprun_out/ab/``.

    python3 chip_ab.py _local/parent . . _local/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "ab")

TRAIN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
card = cs.phase_environment()
cs.phase_build()
cs.phase_train(cs.TrainSlice(), dev, 0, torch.cuda.synchronize, card)
"""


def run(cmd, cwd, log, timeout) -> str:
    with open(log, "w") as f:
        done = subprocess.run(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                              timeout=timeout)
    with open(log) as f:
        text = f.read()
    if done.returncode:
        sys.stdout.write(text[-3000:])
        raise SystemExit(f"{' '.join(cmd[:3])} in {cwd} exited "
                         f"{done.returncode}")
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout directories")
    ap.add_argument("--gate-seed", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        label = f"run {i} ({os.path.relpath(tree, HERE)})"
        text = run([sys.executable, "-c", TRAIN], tree,
                   os.path.join(OUT, f"train_{i}.log"), 900)
        for line in text.splitlines():
            if line.startswith("[train]") and ("median" in line
                                               or "idle share" in line):
                print(f"{label} {line[:260]}", flush=True)
        report = os.path.join(OUT, f"gate_{i}.json")
        t0 = time.perf_counter()
        run([sys.executable, "-m", "tpusr_torch.tools.serving_gate",
             "--task", "hard", "--seeds", str(args.gate_seed),
             "--out", report], tree, os.path.join(OUT, f"gate_{i}.log"), 900)
        wall = time.perf_counter() - t0
        with open(report) as f:
            seeds = json.load(f)["runs"]
        print(f"{label} [gate] {card}: seed {args.gate_seed} of the hard task "
              f"{seeds[0]['elapsed_sec']} s a seed (the report's "
              f"elapsed_sec), the process {wall:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
