"""Readings that set a cell's limits: the program's and its precision
control's, on several seeds in one process.

    python3 -m perfbench.control --workload <name> --seeds <n> [<n> ...] --seconds <s>

For each seed it runs the cell as the benchmark does (set-up, a window of
``--seconds`` at the cell's own load, the check), then puts the reference
computed with fp8 products (``perfbench.reference.t5``, ``prec="fp8"``) in
the program's place on the same inputs and answers. One JSON line a seed:
the program's reading and the control's under each check's name. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from perfbench import harness, run

    run._fix_caches()
    import torch

    if not torch.cuda.is_available():
        print("[control] no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        ctx = harness.context(args.workload, seed, args.seconds, False, control=True)
        ctx.started = time.perf_counter()
        result = harness.driver(ctx.cell["driver"]).run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result.correct,
                          "program": {k: c["value"] for k, c in result.checks.items()},
                          "control": result.window.values.get("control", {}),
                          "limits": {k: c["limit"] for k, c in result.checks.items()},
                          "notes": result.notes}), flush=True)
        del result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
