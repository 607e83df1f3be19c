"""Run one cell of the benchmark on the card and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's files are found by its name (see
``perfbench/harness.py``); every build and kernel cache goes under
``build/`` in the checkout. Standard output's last line is one JSON object:
``correct``, ``attempted``, ``failed``, the cell's end-to-end metrics
(``--trace 0``) or per-layer ones (``--trace 1``), the device, with
``--trace 1`` the trace's ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines of standard error). With no
card, fewer cards than the cell asks for, or a module of JAX or of the JAX
package loaded by the time the window has closed, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_start() -> float:
    """``time.perf_counter()`` at the moment this process started, from its
    start time since boot (falls back to now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def _fix_caches() -> None:
    """Every cache of the program and its libraries at a fixed path in the
    checkout; libraries that would load JAX are told not to."""
    cache = os.path.join(ROOT, "build", "perfbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv: Optional[List[str]] = None) -> int:
    started = _process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fix_caches()
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    bench = harness.benchmark()
    chips = harness.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[perfbench] {args.workload} needs {chips} CUDA card(s); {n} found",
              file=sys.stderr)
        return 3
    print(f"[perfbench] card: {harness.card_state('name,power.limit')}", file=sys.stderr)
    ctx = harness.context(args.workload, args.seed, args.seconds, bool(args.trace))
    ctx.started = started
    result = harness.driver(ctx.cell["driver"]).run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"[perfbench] modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result.memory_peak_bytes}
    line = {"correct": result.correct, "attempted": result.attempted, "failed": result.failed,
            "metrics": harness.metrics(bench, args.workload, result.window, bool(args.trace)),
            "device": device}
    tr = result.window.trace
    if args.trace:
        if tr:
            device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        else:
            print("[perfbench] the profiler recorded no window", file=sys.stderr)
    line["checks"] = result.checks
    for note in result.notes:
        print(f"[perfbench] {note}", file=sys.stderr)
    for name, c in result.checks.items():
        print(f"[perfbench] check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
