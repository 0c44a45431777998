"""Epoch time/memory trackers, early stopping and LR plateau (port of
``tpusr/train/callbacks.py``; reference ``deep_learning_models/callbacks.py``).

The same reported fields (``epoch_times_sec``, ``gpu_mean_current_mb``,
``gpu_peak_mb``), read from ``torch.cuda.memory_stats``. An epoch's time
ends on a device synchronisation, so queued launches are inside it.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _device_memory_info(device=None):
    """{'current': bytes, 'peak': bytes} allocated by torch on a CUDA
    device, or None where there are no stats (the CPU)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(dev)
    if not stats:
        return None
    return {"current": stats.get("allocated_bytes.all.current", 0),
            "peak": stats.get("allocated_bytes.all.peak",
                              stats.get("allocated_bytes.all.current", 0))}


def _synchronize(device) -> None:
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mb(b):
    return None if b is None else float(b) / (1024.0 * 1024.0)


class EpochTimeTracker:
    """Wall-clock per epoch (callbacks.py:104-121), ended on a
    synchronisation of ``device``."""

    def __init__(self, device=None):
        self.device = device
        self._t0 = None
        self.epoch_times_sec: list[float] = []

    def begin_epoch(self):
        self._t0 = time.perf_counter()

    def end_epoch(self):
        if self._t0 is None:
            return
        _synchronize(self.device)
        self.epoch_times_sec.append(time.perf_counter() - self._t0)
        self._t0 = None

    def mean_time_value(self) -> float:
        return float(np.mean(self.epoch_times_sec))


class EpochMemoryTracker:
    """Device memory per epoch (callbacks.py:123-175)."""

    def __init__(self, device=None):
        self.device = device
        self.gpu_mean_current_mb: list[float | None] = []
        self.gpu_peak_mb: list[float | None] = []
        self._begin = None

    def begin_epoch(self):
        self._begin = _device_memory_info(self.device)

    def end_epoch(self):
        begin, end = self._begin, _device_memory_info(self.device)
        cur_b = begin.get("current") if isinstance(begin, dict) else None
        cur_e = end.get("current") if isinstance(end, dict) else None
        if cur_b is not None and cur_e is not None:
            self.gpu_mean_current_mb.append(_mb((cur_b + cur_e) / 2.0))
        else:
            self.gpu_mean_current_mb.append(_mb(cur_e) if cur_e is not None else None)
        pk_b = begin.get("peak") if isinstance(begin, dict) else None
        pk_e = end.get("peak") if isinstance(end, dict) else None
        if pk_b is not None and pk_e is not None:
            self.gpu_peak_mb.append(_mb(max(pk_b, pk_e)))
        else:
            self.gpu_peak_mb.append(_mb(pk_e) if pk_e is not None else None)
        self._begin = None

    def as_dict(self):
        cur = [v for v in self.gpu_mean_current_mb if v is not None]
        pk = [v for v in self.gpu_peak_mb if v is not None]
        return {
            "gpu_mean_current_mb": float(np.mean(cur)) if cur else None,
            "gpu_peak_mb": float(np.max(pk)) if pk else None,
        }


def _copy_tree(tree):
    """A copy of every tensor of a nested dict/list/tuple, on its device."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


class EarlyStopping:
    """monitor='val_loss', restore_best_weights semantics of keras
    EarlyStopping.

    The best weights are a device-side COPY (``detach().clone()`` per
    tensor), taken only on improvement: the trainers update their
    parameters in place, so a reference would follow every later step."""

    def __init__(self, patience: int = 3, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = np.inf
        self.best_state = None
        self.wait = 0
        self.stopped_epoch = None

    def update(self, value: float, state) -> bool:
        """Returns True if training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.best_state = _copy_tree(state)
            self.wait = 0
            return False
        self.wait += 1
        # keras parity: stop AT the patience-th consecutive non-improving
        # epoch (keras EarlyStopping: `if self.wait >= self.patience`)
        return self.wait >= self.patience


class ReduceLROnPlateau:
    """keras ReduceLROnPlateau semantics: scale LR by `factor` AT the
    patience-th epoch without improvement (`wait >= patience`), improvement
    meaning `value < best - min_delta` (keras default min_delta=1e-4),
    floored at `min_lr`."""

    def __init__(self, factor: float = 0.5, patience: int = 2,
                 min_lr: float = 1e-7, min_delta: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.best = np.inf
        self.wait = 0

    def update(self, value: float, current_lr: float) -> float:
        if value < self.best - self.min_delta:
            self.best = value
            self.wait = 0
            return current_lr
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr
