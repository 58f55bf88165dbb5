"""Host input pipeline: deterministic stream -> device, with background
prefetch so batch synthesis overlaps device compute (port of
``repro/data/pipeline.py``)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch


def batches(stream, start_step: int = 0) -> Iterator[dict]:
    """Infinite iterator of global batches (leading worker dim)."""
    step = start_step
    while True:
        yield stream.batch_at(step)
        step += 1


def superbatches(it: Iterator, e: int) -> Iterator:
    """Stack ``e`` consecutive global batches into one ``(E, W, ...)``
    superbatch — the unit one outer round consumes."""
    while True:
        bs = [next(it) for _ in range(e)]
        yield {k: torch.stack([b[k] for b in bs]) for k in bs[0]}


def superbatch_chunks(it: Iterator, e: int, steps: int) -> Iterator:
    """Steps-bounded :func:`superbatches`: yields ``(n, superbatch)``
    covering exactly ``steps`` steps in chunks of ``e`` plus at most one
    shorter tail."""
    done = 0
    while done < steps:
        n = min(e, steps - done)
        bs = [next(it) for _ in range(n)]
        yield n, {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
        done += n


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch (double buffering by default).  Closing
    the generator (``close()``, or dropping it) stops the thread, so the
    batches it holds on the device are freed with it."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = object()
    closed = threading.Event()

    def worker():
        try:
            for item in it:
                if closed.is_set():
                    return
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            yield item
    finally:
        closed.set()
        while t.is_alive():       # unblock a put on a full queue
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
