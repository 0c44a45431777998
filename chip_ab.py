"""Compare checkouts of the port on one card: the training step and the
serving gate's time a seed.

For each checkout, in the order given (run old, new, new, old so that drift
on the card shows), two processes run from that checkout: its own
``chip_smoke.py``'s ``[train]`` phase (the EDSR x4 and VGG16 train steps:
medians by CUDA events, device idle share by ``torch.profiler``), then its
serving gate's CLI on one seed of the hard task (``elapsed_sec`` of the
report; its classifier and EDSR phases by the gate log's clock). The
``[train]`` lines and one line of seconds a seed are printed with the
checkout's label, the card's name and power limit; the whole logs go to
``chiprun_out/ab/``. With ``--profile-steps N``, each distinct checkout
then runs its gate's classifier phase (the VGG16 build, its state and N
steps on seed 0's training surfaces) under ``torch.profiler`` and prints
where the host's time went: the phase's wall time, its build's, and the
operators with the most host time.

    python3 chip_ab.py _local/parent . . _local/parent
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


PROFILE = """
import sys, time, torch
sys.path.insert(0, ".")
from torch.profiler import ProfilerActivity, profile, record_function
import tpusr_torch.tools.serving_gate as sg
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
task = sg.TASKS["hard"]
hr, y = sg.make_surface_images(0, 64, 512, task["amp_range"], task["noise"],
                               task["coverage_range"], device=dev)
torch.cuda.synchronize()
built = {}
cls = sg.VGG16Classifier
def timed_build(*a, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = cls(*a, **kw)
    torch.cuda.synchronize()
    built["ms"] = (time.perf_counter() - t) * 1e3
    return m
sg.VGG16Classifier = timed_build
with profile(activities=[ProfilerActivity.CPU]) as prof:
    t0 = time.perf_counter()
    with record_function("classifier_phase"):
        sg.train_classifier(hr, y, steps=STEPS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
print(f"PHASE {wall:.1f} ms for the crop pool, the build and STEPS steps; "
      f"the VGG16's build {built['ms']:.1f} ms (host clock, synchronised)")
print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                row_limit=25))
"""

# the gate log's clock: "[gate   21s] message"
GATE_LOG = re.compile(r"^\[gate\s+(\d+)s\] (.*)$", re.MULTILINE)


def gate_phases(log: str) -> dict:
    """Seconds of the gate's classifier and EDSR phases by its log's clock
    (whole seconds): from each phase's start line to the next line."""
    lines = [(int(t), msg) for t, msg in GATE_LOG.findall(log)]
    out = {}
    for i, (t, msg) in enumerate(lines[:-1]):
        if msg.startswith("training VGG16"):
            out["classifier_s"] = lines[i + 1][0] - t
        elif msg.startswith("training EDSR"):
            out["edsr_s"] = lines[i + 1][0] - t
    return out


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
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="profile each distinct checkout's gate classifier "
                         "phase over this many steps (0: none)")
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
        log = run([sys.executable, "-m", "tpusr_torch.tools.serving_gate",
                   "--task", "hard", "--seeds", str(args.gate_seed),
                   "--out", report], tree, os.path.join(OUT, f"gate_{i}.log"),
                  900)
        wall = time.perf_counter() - t0
        with open(report) as f:
            seeds = json.load(f)["runs"]
        ph = gate_phases(log)
        print(f"{label} [gate] {card}: seed {args.gate_seed} of the hard task "
              f"{seeds[0]['elapsed_sec']} s a seed (the report's "
              f"elapsed_sec), the process {wall:.1f} s; by the gate log's "
              f"clock the classifier phase {ph.get('classifier_s')} s, the "
              f"EDSR phase {ph.get('edsr_s')} s", flush=True)
    if args.profile_steps:
        for i, tree in enumerate(dict.fromkeys(
                os.path.abspath(t) for t in args.trees)):
            label = f"profile {i} ({os.path.relpath(tree, HERE)})"
            text = run([sys.executable, "-c", PROFILE.replace(
                "STEPS", str(args.profile_steps))], tree,
                os.path.join(OUT, f"profile_{i}.log"), 900)
            at = text.index("PHASE")
            print(f"{label} {card}: " + text[at:at + 3000], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
