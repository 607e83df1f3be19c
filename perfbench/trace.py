"""One profiled window, and its reduction to busy time and a breakdown.

The window is recorded with ``torch.profiler`` (CPU and CUDA activity) and
exported as a Chrome trace under ``TMPDIR``; a ``perfbench.window``
annotation marks its bounds in the trace's own clock. Device activity is
every kernel, copy and fill; busy time is the union of their intervals
inside the window. Each idle gap is put down to the innermost host
operation running when it began (or ``host: python`` where none was).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Any, Callable, ContextManager, Dict, Iterator, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "perfbench.window"
Interval = Tuple[float, float]


@contextlib.contextmanager
def profiled(out: Dict[str, Any], hold: Callable[[], ContextManager] = contextlib.nullcontext
             ) -> Iterator[None]:
    """Profile the block; afterwards ``out["events"]`` holds the trace's
    events. The profiler starts and stops inside a ``hold()`` block each,
    which should stop other threads launching device work meanwhile."""
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with hold():
        prof.__enter__()
    try:
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    finally:
        with hold():
            prof.__exit__(None, None, None)
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f).get("traceEvents", [])


def window_bounds(events: List[Dict[str, Any]]) -> Optional[Interval]:
    """The annotated window, in trace microseconds."""
    for e in events:
        if e.get("name") == WINDOW and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    return None


def device_intervals(events: List[Dict[str, Any]], window: Interval) -> List[Tuple[float, float, str]]:
    """Device activity clipped to ``window``: (start, end, name)."""
    lo, hi = window
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            s, t = max(s, lo), min(t, hi)
            if t > s:
                out.append((s, t, str(e.get("name", "?"))))
    return out


def union(intervals: List[Interval]) -> List[Interval]:
    """Disjoint, sorted union of intervals."""
    merged: List[List[float]] = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_seconds(intervals: List[Interval]) -> float:
    return sum(t - s for s, t in union(intervals)) / 1e6


def gaps(busy: List[Interval], window: Interval) -> List[Interval]:
    """Idle stretches of ``window`` between the busy intervals."""
    out, at = [], window[0]
    for s, t in busy:
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if window[1] > at:
        out.append((at, window[1]))
    return out


def host_ops(events: List[Dict[str, Any]]) -> Tuple[List[float], List[Tuple[float, float, str]]]:
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e.get("name")))
                 for e in events
                 if e.get("cat") in HOST_CATS and e.get("ph") == "X" and e.get("name") != WINDOW)
    return [o[0] for o in ops], ops


def host_at(t: float, starts: List[float], ops: List[Tuple[float, float, str]],
            lookback: int = 4000) -> str:
    """The innermost host operation running at ``t``: of those that cover
    it, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - lookback), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "host: python"


def top(totals: Dict[str, float], n: int = 10) -> List[List[Any]]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def reduce(events: List[Dict[str, Any]], name_chars: int = 160) -> Dict[str, Any]:
    """Busy and window seconds, device time by kernel name, idle time by
    the host's operation, of a trace's annotated window."""
    window = window_bounds(events)
    if window is None:
        return {}
    dev = device_intervals(events, window)
    busy = union([(s, t) for s, t, _ in dev])
    by_op: Dict[str, float] = {}
    for s, t, name in dev:
        key = name[:name_chars]
        by_op[key] = by_op.get(key, 0.0) + (t - s) / 1e6
    starts, ops = host_ops(events)
    by_host: Dict[str, float] = {}
    for s, t in gaps(busy, window):
        key = host_at(s, starts, ops)[:name_chars]
        by_host[key] = by_host.get(key, 0.0) + (t - s) / 1e6
    return dict(busy_s=sum(t - s for s, t in busy) / 1e6,
                window_s=(window[1] - window[0]) / 1e6,
                device_ops=top(by_op), idle_gaps=top(by_host), op_seconds=by_op)
