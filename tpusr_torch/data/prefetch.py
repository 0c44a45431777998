"""Background batch prefetching (a copy of ``tpusr/data/prefetch.py``; the
JAX package's ``__init__`` imports JAX, so the port keeps its own).

The trainers pull batches from plain Python generators: host slicing,
trailing-batch padding and the copy to the card happen inline between steps.
``prefetch_iterator`` wraps any iterator with a daemon reader thread and a
bounded queue: pulling an item in the background executes the generator body
(slice + pad + copy to the device) ahead of consumption, while the bound
keeps at most ``depth`` batches resident beyond the one in flight. Order is
preserved exactly, and a generator exception re-raises at the consumer's
``next()``, semantics identical to iterating directly.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iterator(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a background thread, keeping up to ``depth`` items
    staged ahead of the consumer. ``depth <= 0`` returns ``iter(it)``."""
    if depth <= 0:
        return iter(it)

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()  # consumer abandoned iteration (exception/break)

    def _put(item) -> bool:
        # Bounded-timeout put so an abandoned consumer (train-step exception,
        # KeyboardInterrupt mid-epoch) can't leave the reader blocked forever
        # holding staged device batches — it notices `stop` and exits.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as exc:  # re-raised at the consumer's next()
            _put(_Failure(exc))
        else:
            _put(_DONE)

    t = threading.Thread(target=reader, daemon=True)
    t.start()

    def consume():
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            # runs on normal exhaustion, consumer exception, and generator
            # close alike; lets the reader thread drain out
            stop.set()

    return consume()
