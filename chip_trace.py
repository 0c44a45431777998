#!/usr/bin/env python3
"""Measure how torch.profiler keeps a session's kernel records on one card.

    python3 chip_trace.py [SECONDS]

For SECONDS (default 180) it alternates two kinds of session, each a
``torch.profiler`` window over a lead of 256 one-element adds in a
``trace_lead`` span and one EDSR x4 forward (batch 16 of 32^2): one that
starts the lead as soon as the window opens, and one that first waits 20 ms
with the card idle. Between sessions the card runs 20 such forwards. For
each session it counts the lead's and the block's launches with no kernel
record (``chip_smoke.trace_records``) and the least and the median time
from a launch record to its kernel's record (negative: the kernel's time,
converted from the card's clock, reads before its launch). It prints a line
per kind and writes every session to ``chiprun_out/trace_study.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WAITS_MS = (0, 20)
LEAD = 256


def session(model, x, wait_ms: float, path: str) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import trace_records
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    if wait_ms:
        torch.cuda.synchronize()
        time.sleep(wait_ms / 1e3)
    with record_function("trace_lead"):
        z = torch.zeros(1, device=x.device)
        for _ in range(LEAD):
            z.add_(1.0)
        torch.cuda.synchronize()
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "LaunchKernel" in e.get("name", "")}
    kernel = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "kernel"}
    delay = [kernel[c] - launch[c] for c in kernel if c in launch]
    return {"wait_ms": wait_ms, **trace_records(events, "trace_lead"),
            "delay_min_us": min(delay), "delay_median_us":
            statistics.median(delay)}


def main() -> int:
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 180.0
    if not torch.cuda.is_available():
        print("chip_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import phase_environment
    from tpusr_torch.models import EDSR

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_environment()
    model = EDSR(scale_factor=4, device=dev, key=0)
    x = torch.rand(16, 32, 32, 3, device=dev)
    rows = []
    end = time.perf_counter() + seconds
    with tempfile.TemporaryDirectory() as tmp:
        while time.perf_counter() < end:
            with torch.no_grad():
                for _ in range(20):
                    model(x)
            torch.cuda.synchronize()
            for wait in WAITS_MS:
                rows.append(session(model, x, wait,
                                    os.path.join(tmp, "trace.json")))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "trace_study.json"), "w") as f:
        json.dump(rows, f)
    for wait in WAITS_MS:
        r = [row for row in rows if row["wait_ms"] == wait]
        lost = [row["lead_lost"] for row in r]
        print(f"[trace] {card}: wait {wait} ms: {len(r)} sessions, "
              f"{sum(1 for v in lost if v)} lost lead records (at most "
              f"{max(lost)} of {r[0]['lead']}), block records lost at most "
              f"{max(row['block_lost'] for row in r)} of {r[0]['block']}; "
              f"launch to kernel record at least "
              f"{min(row['delay_min_us'] for row in r):.1f} us, median "
              f"{statistics.median(row['delay_median_us'] for row in r):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
