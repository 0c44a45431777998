"""Profiling helpers (port of ``tpusr/train/profiling.py``): a
``torch.profiler`` trace, a steady-state timing harness and the device's
allocator statistics.

- ``trace(log_dir)`` records the host and, on a card, the device's kernels
  while its block runs (after a lead of tiny kernels, see ``trace``), and
  writes one Chrome trace (viewable in Perfetto or ``chrome://tracing``)
  into ``log_dir``.
- ``time_compiled(fn, *args)`` keeps the JAX name: the port compiles nothing
  per call, so it times steady-state calls after ``warmup`` of them,
  waiting for the device that holds the result at both ends.
- ``device_memory_mb`` reads torch's allocator; on the CPU it returns zeros,
  as the JAX function does where a device has no memory statistics.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


# tiny kernels ``trace`` launches before the block on a card, inside a
# ``TRACE_LEAD_NAME`` span of the trace (see there)
TRACE_LEAD_KERNELS = 256
TRACE_LEAD_NAME = "trace_lead"
# seconds ``trace`` waits on the host, the card idle, after the profiler's
# window opens and before it closes (see there)
TRACE_MARGIN_S = 0.05


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA where
    a card is present) and write it to ``log_dir/trace.json``.

    On the H100 the profiler has lost the kernel records of the first
    launches of a session (their launch records stay) late in a long
    process: it keeps a kernel only if the kernel's time, converted from
    the card's clock, falls inside its window, and that time has read up to
    5.5 ms before the kernel's own launch. So on a card the trace waits
    ``TRACE_MARGIN_S``
    with the card idle after the window opens and again before it closes,
    and opens with ``TRACE_LEAD_KERNELS`` one-element adds in a span named
    ``TRACE_LEAD_NAME``; the lead's missing records measure what the
    margin did not absorb, and the block's own kernels are all in the
    trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        with record_function(TRACE_LEAD_NAME):
            lead = torch.zeros(1, device="cuda")
            for _ in range(TRACE_LEAD_KERNELS):
                lead.add_(1.0)
            torch.cuda.synchronize()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _devices_of(out) -> set:
    """The CUDA devices holding the tensors of ``out`` (a tensor or a nested
    tuple / list / dict of them)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_devices_of(o) for o in out)) if out else set()
    return set()


def _wait(out) -> None:
    for dev in _devices_of(out):
        torch.cuda.synchronize(dev)


def time_compiled(fn, *args, iters: int = 10, warmup: int = 1):
    """Steady-state seconds per call of ``fn(*args)``: ``warmup`` calls,
    then ``iters`` timed by the host clock, each end waiting for the
    device that holds the result (the reference's ``time_algorithm``,
    profiling_methods.py:17-27, with the warm-up excluded)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait(out)
    return (time.perf_counter() - t0) / iters


def device_memory_mb(device=None) -> dict:
    """Current and peak allocated memory in MB of ``device`` (by default the
    current card), from torch's allocator; zeros on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"current_mb": 0.0, "peak_mb": 0.0}
    stats = torch.cuda.memory_stats(dev)
    mb = 1024.0 * 1024.0
    cur = stats.get("allocated_bytes.all.current", 0)
    return {"current_mb": cur / mb,
            "peak_mb": stats.get("allocated_bytes.all.peak", cur) / mb}
