"""The one traffic generator: reads a mix's parameters, draws from the seed.

A mix is a JSON file under ``perfbench/traffic/``. Its length
distributions are written as

- ``{"uniform": [lo, hi]}``: every whole length from ``lo`` to ``hi``;
- ``{"lognormal": {"median": m, "sigma": s, "min": lo, "max": hi}}``,
  clipped to ``[lo, hi]``;
- ``{"mixture": [{"weight": w, ...one of the above...}, ...]}``.

Every seed gets the same multiset of lengths: ``n`` draws are the
distribution's quantiles at ``(i + 1/2) / n`` (a mixture gives each part
its share of ``n``), and the seed only orders them and fills their bytes.
So runs with different seeds do the same work in a different order, and the
spread between seeds is the system's, not the draw's.
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Any, Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Printable ASCII with spaces and newlines weighted as in source text.
_ALPHABET = np.frombuffer(
    (bytes(range(33, 127)) + b" " * 16 + b"\n" * 3), dtype=np.uint8)


def load_mix(name: str) -> Dict[str, Any]:
    """The mix ``perfbench/traffic/<name>.json``."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (seeds may exceed 32 bits)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def _quantiles(spec: Dict[str, Any], n: int) -> np.ndarray:
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    u = (np.arange(n) + 0.5) / n
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return np.floor(lo + u * (hi - lo + 1)).astype(np.int64).clip(lo, hi)
    if "lognormal" in spec:
        p = spec["lognormal"]
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        vals = np.round(p["median"] * np.exp(p["sigma"] * z)).astype(np.int64)
        return vals.clip(p["min"], p["max"])
    if "mixture" in spec:
        parts = spec["mixture"]
        total = sum(part["weight"] for part in parts)
        counts = [int(math.floor(n * part["weight"] / total)) for part in parts]
        counts[0] += n - sum(counts)
        return np.concatenate([_quantiles(part, c) for part, c in zip(parts, counts)])
    raise ValueError(f"unknown length distribution: {sorted(spec)}")


def lengths(spec: Dict[str, Any], n: int, seed: int, stream: int = 0) -> np.ndarray:
    """``n`` lengths of ``spec`` in the order ``seed`` gives them."""
    vals = _quantiles(spec, n)
    return vals[rng(seed, 1, stream).permutation(n)]


def texts(byte_lengths: np.ndarray, seed: int, stream: int = 0) -> List[str]:
    """One ASCII text of each length, its bytes drawn from ``seed``, made
    in one draw."""
    total = int(np.sum(byte_lengths))
    buf = _ALPHABET[rng(seed, 2, stream).integers(0, len(_ALPHABET), total)].tobytes()
    out, at = [], 0
    for n in byte_lengths.tolist():
        out.append(buf[at: at + n].decode("ascii"))
        at += n
    return out
