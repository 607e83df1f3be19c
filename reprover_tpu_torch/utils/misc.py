"""Small glue utilities: a copy of ``reprover_tpu/utils/misc.py:1-24``
(`/root/reference/common.py:428-443` roles), which the port may not
import."""

from __future__ import annotations

import logging
import sys
from typing import Any


def zip_strict(*args: Any) -> Any:
    """zip() asserting equal lengths (`common.py:428-430`)."""
    lengths = {len(a) for a in args if hasattr(a, "__len__")}
    assert len(lengths) <= 1, f"zip_strict length mismatch: {lengths}"
    return zip(*args)


def set_logger(verbose: bool) -> None:
    """Global verbosity switch (`common.py:433-443`, loguru -> logging)."""
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True,
    )


def cap_cpu_threads(n: int = 1) -> None:
    """Cap torch's intra-op CPU threads at ``n``.

    The port's CPU tests call this at import: the tier-1 suite runs six
    pytest workers on eight cores, and torch's default of one OpenMP
    thread per core in each worker, beside JAX's pools, spins the threads
    against each other (a 1.3 s case took over 100 s among five busy
    processes; README, "Testing on the CPU")."""
    import torch

    torch.set_num_threads(n)
