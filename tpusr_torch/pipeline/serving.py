"""Micro-batching inference server (port of ``tpusr/pipeline/serving.py``).

Callers submit single LR images; a background worker coalesces them into
fixed-size batches (padding the tail by repeating the last image and marking
the pad rows with ``n_valid``), runs the pipeline, and resolves one future per
request.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class PipelineServer:
    """Micro-batching wrapper around a ``FusedSRClassifyPipeline`` (or any
    callable taking an (N, h, w, 3) batch and returning (sr, classes,
    confidences) tensors).

    Args:
        pipeline: the pipeline; it runs on its own device.
        batch_size: fixed batch; requests are coalesced up to this.
        max_wait_ms: max time the batcher waits to fill a batch.
    """

    def __init__(self, pipeline, batch_size: int = 16, max_wait_ms: float = 5.0):
        self.pipeline = pipeline
        # signature check once (not try/except around the call: a TypeError
        # raised inside the pipeline must fail the batch, not silently rerun)
        try:
            self._pass_n_valid = "n_valid" in inspect.signature(pipeline).parameters
        except (TypeError, ValueError):
            self._pass_n_valid = False
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._started = False

    # ------------------------------------------------------------------ API
    def start(self):
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def stop(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        if self._started:
            self._worker.join(timeout=5.0)
        # fail any requests still queued, so no waiter blocks out its timeout
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("PipelineServer stopped"))

    def submit(self, lr_image: np.ndarray) -> Future:
        """Submit one (h, w, 3) [0, 1] LR image; resolves to
        {'sr': ndarray, 'class': int, 'confidence': float}."""
        if self._stop.is_set():
            raise RuntimeError("PipelineServer is stopped")
        fut: Future = Future()
        self._q.put((np.asarray(lr_image, np.float32), fut))
        return fut

    def classify(self, lr_image: np.ndarray, timeout: float = 60.0) -> dict:
        """Blocking convenience wrapper."""
        return self.submit(lr_image).result(timeout=timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---------------------------------------------------------------- worker
    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                continue
            batch = [first]
            # absolute deadline from the first item: max_wait caps the total
            # coalescing latency, not each per-item wait
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    break
                batch.append(item)
            self._run_batch(batch)

    def _run_batch(self, batch):
        try:
            # batch assembly stays inside the try: a mismatched-shape request
            # must fail its batch's futures, not kill the worker thread
            imgs = np.stack([b[0] for b in batch])
            n = imgs.shape[0]
            if n < self.batch_size:  # pad to the fixed batch shape
                padrows = np.repeat(imgs[-1:], self.batch_size - n, axis=0)
                imgs = np.concatenate([imgs, padrows])
            # n_valid marks the pad rows so the cascade's top-K escalation
            # never spends slots on duplicated padding
            if self._pass_n_valid:
                out = self.pipeline(imgs, n_valid=n)
            else:
                out = self.pipeline(imgs)
            sr, classes, confs = (t.cpu().numpy() for t in out)
            for i, (_, fut) in enumerate(batch):
                if not fut.done():  # a cancelled co-batched future must not
                    fut.set_result({  # poison the rest of the batch
                        "sr": sr[i],
                        "class": int(classes[i]),
                        "confidence": float(confs[i]),
                    })
        except Exception as e:  # propagate to all waiters
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
