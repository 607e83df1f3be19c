"""Profiling hooks: the port's counterpart of
``reprover_tpu/utils/profiling.py:1-56``, and its spans and counters.

``device_trace`` records with ``torch.profiler`` instead of
``jax.profiler``: CPU activity always, CUDA activity when the device is a
CUDA one, and writes a Chrome trace (JSON) under ``log_dir``::

    with device_trace("/tmp/trace", device="cuda") as prof:
        retriever.reindex_corpus(64)
    prof.key_averages()  # or open the trace in chrome://tracing / Perfetto

``SectionTimer`` (the JAX package's, made safe to share between threads)
sums seconds per named section and counts per named counter. One of them,
``REGISTRY``, is the process's: the program times its host phases with
``span(name)``, counts its work with ``count(name, n)``, and a reader takes
``counters()``, a snapshot of both, at any moment (two snapshots give a
window's share)::

    with span("retriever.serialize"):
        texts = [p.serialize() for p in premises]
    count("retriever.premises_prepared", len(texts))
    counters()["retriever.serialize.seconds"]

A section costs two clock reads and two dictionary updates under a lock;
while a ``torch.profiler`` session records, it is also a
``record_function`` range, so the trace holds it on the kernels' clock,
nested in its parent (the Chrome trace's ``user_annotation`` events).
Totals are kept by name alone, so memory does not grow with the run.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Callable, ContextManager, Dict, Iterator, Optional, Union

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: str, device: Union[str, torch.device] = "cuda",
                 hold: Callable[[], ContextManager] = contextlib.nullcontext,
                 ) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block; on leaving it, write
    ``log_dir/trace.json`` (Chrome trace format). Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read. The profiler
    starts and stops inside a ``hold()`` block each: where other threads
    launch device work, ``hold`` should stop them for that time
    (``InferenceService.quiesced``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with hold():
        prof.__enter__()
    try:
        yield prof
    finally:
        with hold():
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            prof.__exit__(None, None, None)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("torch profiler trace written to %s", path)


class SectionTimer:
    """Seconds and entries per named section (host-side phases), and a sum
    per named counter; safe to share between threads."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}  # section -> seconds
        self.counts: Dict[str, int] = {}  # section -> entries
        self.tallies: Dict[str, float] = {}  # counter -> sum
        self._lock = threading.Lock()

    def section(self, name: str) -> "_Section":
        """Time the block under ``name``: on leaving it, even by an
        exception, add its seconds and one entry to ``name``'s totals."""
        return _Section(self, name)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.tallies[name] = self.tallies.get(name, 0) + n

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def snapshot(self) -> Dict[str, float]:
        """Every section as ``<name>.seconds`` and ``<name>.calls``, and
        every counter under its own name."""
        with self._lock:
            out: Dict[str, float] = {f"{k}.seconds": v for k, v in self.totals.items()}
            out.update((f"{k}.calls", v) for k, v in self.counts.items())
            out.update(self.tallies)
        return out

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))


class _Section:
    """One entry of a :class:`SectionTimer` section; a ``record_function``
    range too while the profiler records (and never enters one otherwise)."""

    __slots__ = ("_timer", "_name", "_t0", "_range")

    def __init__(self, timer: SectionTimer, name: str) -> None:
        self._timer, self._name = timer, name
        self._range: Optional[Any] = None

    def __enter__(self) -> None:
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc: Any) -> None:
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self._timer._add(self._name, seconds)


REGISTRY = SectionTimer()


def span(name: str) -> "_Section":
    """A section of the process's registry (see the module's docstring)."""
    return REGISTRY.section(name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the process's counter ``name``."""
    REGISTRY.count(name, n)


def counters() -> Dict[str, float]:
    """A snapshot of the process's sections and counters."""
    return REGISTRY.snapshot()
