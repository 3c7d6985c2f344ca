"""Background-thread batch prefetcher (port of ws3d_tpu/utils/prefetch.py).

One thread runs the host-side NumPy batch pipeline ahead of the train step
through a small queue. Closing the generator (or leaving a for loop over
it) stops the thread at its next put.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

_SENTINEL = object()


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:                 # propagate to consumer
            put(e)
            return
        put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)
