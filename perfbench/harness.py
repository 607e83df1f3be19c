"""What every cell shares: finding its files by name, the run's context,
the metric readers, the result line.

A cell ``<name>`` of ``BENCHMARK.json`` has ``perfbench/cells/<name>.json``,
which names its driver (``perfbench/drivers/<driver>.py``) and the
driver's settings; the workload entry names its configuration
(``perfbench/configs/<config>.json``) and traffic mix
(``perfbench/traffic/<traffic>.json``). Each metric ``<metric>``, end to
end or per layer, has a reader ``perfbench/metrics/<metric>.py`` whose
``read(w)`` takes the driver's :class:`Window` and returns a number, or
None where it finds nothing to read. Which metrics a cell reports comes
from ``BENCHMARK.json``: those that list the cell under ``workloads``, and
those without ``workloads`` that move an end-to-end metric the cell
reports. So a cell, mix, configuration or metric is added by adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "reprover_tpu")


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: Optional[str] = None) -> Dict[str, Any]:
    return load_json(root or ROOT, "BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT, c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict[str, Any], cell: str) -> Dict[str, List[Dict[str, Any]]]:
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def load_module(path: str, name: str) -> Any:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[["Window"], Optional[float]]:
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    return load_module(path, "perfbench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def driver(name: str) -> Any:
    return load_module(os.path.join(HERE, "drivers", f"{name}.py"), "perfbench_driver_" + name)


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, its files, the run's arguments."""

    name: str
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    # Width and depth overrides for CPU checks of the control flow; None on
    # the chip.
    sizes_override: Optional[Dict[str, Any]] = None
    # Also compute the precision control's reading after the check.
    control: bool = False
    # ``time.perf_counter()`` at the process's start (set-up runs from it).
    started: float = 0.0

    @property
    def sizes(self) -> Dict[str, Any]:
        s = dict(self.config)
        s.update(self.sizes_override or {})
        return s


@dataclasses.dataclass
class Window:
    """What a driver hands the metric readers: its measured window, the
    program's counters at the window's two ends, the trace's reduction and
    any counts the driver made from the shapes it ran."""

    seconds: float
    setup_s: float
    # Whether the window ran on a card: a CPU run reports no metric.
    on_card: bool = True
    counters: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    values: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def delta(self, key: str) -> Optional[float]:
        a, b = self.counters.get("open", {}), self.counters.get("close", {})
        if key not in a or key not in b:
            return None
        return float(b[key]) - float(a[key])


def context(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            sizes_override: Optional[Dict[str, Any]] = None, control: bool = False) -> Context:
    bench = benchmark()
    w = workload(bench, name)
    from perfbench.traffic import load_mix

    return Context(name=name, cell=load_json(HERE, "cells", f"{name}.json"),
                   config=config_of(bench, w["config"]), traffic=load_mix(w["traffic"]),
                   seed=seed, seconds=seconds, trace=trace, device=device,
                   sizes_override=sizes_override, control=control)


@dataclasses.dataclass
class Result:
    """A driver's run: the window for the readers, each number compared
    with its limit, the work attempted and failed, the device's peak."""

    window: Window
    checks: Dict[str, Dict[str, float]]
    attempted: int
    failed: int
    memory_peak_bytes: Optional[int]
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def port_t5_config(sizes: Dict[str, Any], dtype: Any) -> Any:
    """The port's ``T5Config`` of a configuration file's sizes."""
    from reprover_tpu_torch.models.t5 import T5Config

    return T5Config(
        vocab_size=sizes["vocab_size"], d_model=sizes["d_model"], d_kv=sizes["d_kv"],
        d_ff=sizes["d_ff"], num_heads=sizes["num_heads"],
        num_encoder_layers=sizes["num_layers"], num_decoder_layers=sizes["num_decoder_layers"],
        relative_attention_num_buckets=sizes["relative_attention_num_buckets"],
        relative_attention_max_distance=sizes["relative_attention_max_distance"],
        layer_norm_epsilon=sizes["layer_norm_epsilon"],
        tie_word_embeddings=sizes["tie_word_embeddings"], pad_token_id=sizes["pad_token_id"],
        eos_token_id=sizes["eos_token_id"],
        decoder_start_token_id=sizes["decoder_start_token_id"], compute_dtype=dtype)


def byte_ids(text: str, max_len: int, eos: int = 1, offset: int = 3) -> List[int]:
    """ByT5 ids of ``text`` as a model of ``max_len`` positions reads it:
    each byte plus ``offset``, cut to leave room for the EOS that ends it."""
    return [b + offset for b in text.encode("utf-8")][: max_len - 1] + [eos]


def card_state(fields: str = "clocks.sm,power.draw,temperature.gpu") -> str:
    """``fields`` of the card now, as ``nvidia-smi`` reads them (by default
    the SM clock, power draw and temperature, for the notes beside a
    window)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metrics(bench: Dict[str, Any], name: str, w: Window, trace: bool) -> Dict[str, Any]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    entries = cell_metrics(bench, name)["per_layer" if trace else "end_to_end"]
    out: Dict[str, Any] = {}
    if not w.on_card:
        return out
    for m in entries:
        value = reader(m["name"])(w)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
