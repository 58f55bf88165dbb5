"""Compilation/dispatch accounting hooks — port of ``repro/dist/monitor.py``.

The round contract ("steady rounds build nothing, one call of the round
function a round") regresses silently: a shape that changes from round to
round, or a kernel source whose library is rebuilt, costs time without
failing any correctness test.  Two cheap counters guard it:

  * :func:`compile_count`: a context manager counting the port's
    compilations inside the block, the ``nvcc`` builds that
    ``repro_torch.kernels._build`` starts (a library already built, or
    already loaded, counts zero); the port runs eagerly, so there is
    nothing else to compile;
  * :func:`counting`: wraps any callable (e.g. an engine's round
    function) with an invocation counter, for asserting calls per round.

Blocks may nest or overlap: each reads the counter's delta.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from ..kernels import _build


@dataclass
class CompileStats:
    compiles: int = 0


@contextlib.contextmanager
def compile_count():
    """``with compile_count() as stats: ...``; afterwards ``stats.compiles``
    is the number of kernel builds started inside the block."""
    start = _build.builds_started()
    stats = CompileStats()
    try:
        yield stats
    finally:
        stats.compiles = _build.builds_started() - start


def _sync(out) -> None:
    """Wait for the card(s) that hold any tensor of ``out`` (nested
    dicts, lists and tuples); the CPU needs no wait."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(out)
    for d in devices:
        torch.cuda.synchronize(d)


def probe_seconds(fn, *args, reps: int = 3, warmup: int = 1
                  ) -> tuple[float, int]:
    """Median wall-seconds per call of ``fn(*args)`` after ``warmup``
    calls, each timed call ending when the card has finished its output,
    plus the number of kernel builds seen during the TIMED calls (nonzero
    means the probe timed ``nvcc``, not the computation)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync(out)
    with compile_count() as stats:
        ts = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(out)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], stats.compiles


@dataclass
class CallCounter:
    calls: int = 0
    by_label: dict = field(default_factory=dict)

    def wrap(self, fn, label: str = ""):
        """Count invocations of ``fn`` (shared counter + per-label)."""
        def wrapped(*a, **kw):
            self.calls += 1
            if label:
                self.by_label[label] = self.by_label.get(label, 0) + 1
            return fn(*a, **kw)
        return wrapped


def counting(fn, label: str = "") -> tuple:
    """(wrapped_fn, CallCounter) for a single callable."""
    c = CallCounter()
    return c.wrap(fn, label), c
