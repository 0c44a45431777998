"""The port's profiling helpers (tpusr_torch/train/profiling.py) against the
JAX package's (tpusr/train/profiling.py) on the CPU: the trace file, the
steady-state timer's calls and its result, the memory statistics where
a device has none, and the count of a trace's lost kernel records that the
card checks read. Their card paths (CUDA events in the trace, the wait on
the result's card, the allocator's figures) are in tests/test_torch_cuda.py."""

import json

import jax.numpy as jnp
import pytest
import torch

from tpusr.train import profiling as jprof
from tpusr_torch.train import profiling


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    a = torch.rand(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        for _ in range(3):
            a = a @ a.T / 64
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = [e.get("name", "") for e in events["traceEvents"]]
    assert sum("matmul" in n or "mm" in n for n in names) >= 3
    assert any(e.key == "aten::matmul" for e in prof.key_averages())


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with profiling.trace(str(tmp_path)):
            torch.ones(3).sum()
            raise RuntimeError("boom")
    assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("iters,warmup", [(10, 1), (3, 0), (1, 4)])
def test_time_compiled_calls_as_jax_does(iters, warmup):
    calls = {"port": 0, "jax": 0}

    def fn(key, x):
        calls[key] += 1
        return x * 2

    t = profiling.time_compiled(fn, "port", torch.ones(4), iters=iters,
                                warmup=warmup)
    tj = jprof.time_compiled(fn, "jax", jnp.ones(4), iters=iters,
                             warmup=warmup)
    assert calls["port"] == calls["jax"] == iters + warmup
    assert t > 0 and tj > 0


def test_time_compiled_takes_nested_results():
    out = profiling.time_compiled(
        lambda: {"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}, iters=2)
    assert out > 0


def test_device_memory_mb_is_zero_without_device_statistics():
    want = jprof.device_memory_mb()          # the CPU: no memory_stats()
    assert profiling.device_memory_mb("cpu") == want == {"current_mb": 0.0,
                                                         "peak_mb": 0.0}
    if not torch.cuda.is_available():
        assert profiling.device_memory_mb() == want


def test_trace_records_counts_the_lost_kernel_records():
    """``chip_smoke.trace_records`` (what the card checks read from a
    trace): launches inside the lead span count as the lead's, later ones as
    the block's, and a launch whose correlation id has no kernel record is
    lost; launches before the span and other runtime calls are ignored."""
    from chip_smoke import trace_records

    def launch(ts, c, name="cudaLaunchKernel"):
        return {"cat": "cuda_runtime", "name": name, "ts": ts,
                "args": {"correlation": c}}

    def kernel(c):
        return {"cat": "kernel", "name": "k", "ts": 0, "args": {"correlation": c}}
    events = [
        {"cat": "user_annotation", "name": "trace_lead", "ts": 10, "dur": 10},
        launch(5, 1), launch(10, 2), launch(15, 3), launch(20, 4),
        launch(25, 5), launch(30, 6), launch(35, 7, "cudaMemcpyAsync"),
        launch(40, 8, "cudaLaunchKernelExC"),
        kernel(1), kernel(3), kernel(4), kernel(5), kernel(8)]
    assert trace_records(events, "trace_lead") == {
        "lead": 3, "lead_lost": 1, "block": 3, "block_lost": 1}
