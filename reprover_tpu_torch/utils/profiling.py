"""Profiling hooks: the port's counterpart of
``reprover_tpu/utils/profiling.py:1-56``.

``SectionTimer`` is copied. ``device_trace`` records with
``torch.profiler`` instead of ``jax.profiler``: CPU activity always, CUDA
activity when the device is a CUDA one, and writes a Chrome trace (JSON)
under ``log_dir``::

    with device_trace("/tmp/trace", device="cuda") as prof:
        retriever.reindex_corpus(64)
    prof.key_averages()  # or open the trace in chrome://tracing / Perfetto
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Union

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: str, device: Union[str, torch.device] = "cuda"
                 ) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block; on leaving it, write
    ``log_dir/trace.json`` (Chrome trace format). Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("torch profiler trace written to %s", path)


class SectionTimer:
    """Accumulate wall-clock per named section (host-side phases)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
