"""Host-side input pipeline: a worker thread builds the next samples while
the device runs the current step (counterpart of ``zest_tpu.data.pipeline``).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..system import to_batch

_DONE = object()


def prefetch_to_device(dataset, order: Iterator[int], device,
                       buffer_size: int = 2):
    """Yield ``dataset[i]`` for each i of ``order`` as a batch on ``device``
    (``system.to_batch``). A worker thread builds up to ``buffer_size``
    numpy samples ahead; the consumer's thread moves each to the device. An
    exception in the worker is raised here, in the consumer. Closing the
    generator early stops the worker and waits for it."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for idx in order:
                if not put(dataset[int(idx)]):
                    return
        except Exception as e:      # raised again by the consumer
            put(e)
            return
        put(_DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield to_batch(item, device)
    finally:
        stop.set()
        t.join()


def epoch_order(n: int, epochs: int, seed: int = 0) -> Iterator[int]:
    """Shuffled indices of n samples, one permutation per epoch, from one
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        yield from rng.permutation(n)
