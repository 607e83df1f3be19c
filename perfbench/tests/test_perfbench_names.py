"""``BENCHMARK.json`` keeps to the contract's names, units, keys and limits,
and every name in it has its files."""

import json
import os
import re

import pytest

from perfbench.harness import HERE, ROOT

PATH = os.path.join(ROOT, "BENCHMARK.json")
BENCH = json.load(open(PATH))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|d_model|d_ff|d_kv|"
                   r"expansion|experts_per_tok")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_perfbench_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(PATH) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))


@pytest.mark.parametrize("section", sorted(KEYS))
def test_perfbench_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_perfbench_configs_and_cells():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert configs == used
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert os.path.isfile(os.path.join(HERE, "cells", w["name"] + ".json"))
        assert os.path.isfile(os.path.join(HERE, "traffic", w["traffic"] + ".json"))


def test_perfbench_metrics_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells), (m["name"], c)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for name in list(e2e) + [m["name"] for m in BENCH["per_layer"]]:
        assert os.path.isfile(os.path.join(HERE, "metrics", name + ".py")), name
    for c in cells:  # setup_s, another end-to-end metric, a per-layer metric
        reported = [m for m in BENCH["end_to_end"] if c in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])
        assert any("mfu" in m["name"] and c in m["workloads"] for m in BENCH["per_layer"])


def test_perfbench_files_under_paths_named_from_names():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "perfbench")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            if "__pycache__" in rel:
                continue
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
