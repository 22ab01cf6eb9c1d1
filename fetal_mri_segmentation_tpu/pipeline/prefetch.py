"""Background prefetch: overlap host batch assembly + H2D transfer with device compute.

The reference's generator ran synchronously inside fit_generator — every step
waited for a full host read+augment cycle (SURVEY.md section 3.1 hot loop).
Here a daemon thread keeps a small queue of ready batches and eagerly calls
`jax.device_put`, so the (asynchronous) H2D DMA is in flight while the
previous step computes. With device-side augmentation this makes the input
path effectively free for BASELINE config #2.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class _Stop:
    pass


def prefetch(generator: Iterator, size: int = 2,
             device_put: Optional[Callable] = None) -> Iterator:
    """Wrap an iterator with a bounded background-producer queue.

    ``device_put``: optional callable applied to each item in the producer
    thread (e.g. ``lambda b: jax.device_put(b, sharding)``) so transfers are
    issued ahead of consumption.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop_flag = threading.Event()

    def put_checking_stop(item) -> bool:
        """q.put that re-checks stop_flag so an abandoned consumer (e.g. an
        exception in the train step) never leaves the producer blocked on a
        full queue holding device buffers. Returns False once stopped."""
        while not stop_flag.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in generator:
                if stop_flag.is_set():
                    return
                if device_put is not None:
                    item = device_put(item)
                if not put_checking_stop(item):
                    return
        except Exception as e:  # surface producer errors to the consumer
            put_checking_stop(e)
        finally:
            put_checking_stop(_Stop())

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    try:
        while True:
            item = q.get()
            if isinstance(item, _Stop):
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop_flag.set()
