"""Structured training observability (a copy of ``tpusr/train/logging.py``;
the JAX package's ``__init__`` imports JAX, so the port keeps its own).

A per-step/per-epoch metric logger writing JSON-lines (machine-readable,
append-only, the schema the comparison panels consume) with CSV export.
Metric values may be torch tensors on any device.
"""

from __future__ import annotations

import csv
import json
import os
import time

import torch


class MetricsLogger:
    """Append-only JSONL metrics log with epoch/step scoping."""

    def __init__(self, path: str, run_name: str = "run", echo: bool = False):
        self.path = path
        self.run_name = run_name
        self.echo = echo
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, scope: str, step: int, metrics: dict):
        # metrics first, fixed fields second: a metric named run/scope/step/
        # time must not clobber the record schema read_jsonl filters on
        rec = {**{k: _jsonable_value(v) for k, v in metrics.items()},
               "run": self.run_name, "scope": scope, "step": int(step),
               "time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.echo:
            print(rec)

    def log_epoch(self, epoch: int, metrics: dict):
        self.log("epoch", epoch, metrics)

    def log_step(self, step: int, metrics: dict):
        self.log("step", step, metrics)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable_value(v):
    """Scalars -> float; arrays (ndarray, tensors on any device, any size) ->
    nested lists — float(v) on a multi-element array raises TypeError
    mid-training."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    if hasattr(v, "tolist") and getattr(v, "ndim", 0) > 0:
        return v.tolist()
    if hasattr(v, "__float__"):
        return float(v)
    return v


def read_jsonl(path: str, scope: str | None = None) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if scope is None or rec.get("scope") == scope:
                out.append(rec)
    return out


def jsonl_to_csv(jsonl_path: str, csv_path: str, scope: str | None = None):
    rows = read_jsonl(jsonl_path, scope)
    if not rows:
        return
    keys = sorted({k for r in rows for k in r})
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
