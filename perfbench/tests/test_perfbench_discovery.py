"""A cell, configuration, traffic mix and metric added as new files are
found by name, with no existing file edited."""

import json
import os
import shutil

from perfbench import harness, traffic


def test_perfbench_new_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    here = root / "perfbench"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    (here / "configs" / "new-config.json").write_text(json.dumps({"d_model": 8, "num_layers": 1}))
    (here / "traffic" / "new_mix.json").write_text(json.dumps({"clients": 3}))
    (here / "cells" / "new.cell.json").write_text(json.dumps({"driver": "search", "num_slots": 2}))
    (here / "metrics" / "new_metric.cell.py").write_text(
        "def read(w):\n    return w.values['answer'] * 2\n")
    bench["configs"].append({"name": "new-config", "source": "https://example.org/new",
                             "file": "perfbench/configs/new-config.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "new.cell", "config": "new-config", "traffic": "new_mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new_metric.cell", "unit": "ms", "better": "lower",
                               "source": "program_counter", "layer": "serving",
                               "moves": "setup_s", "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(here))
    monkeypatch.setattr(traffic, "HERE", str(here))

    ctx = harness.context("new.cell", 1, 1.0, False)
    assert ctx.cell == {"driver": "search", "num_slots": 2}
    assert ctx.config == {"d_model": 8, "num_layers": 1}
    assert ctx.traffic == {"clients": 3}
    assert hasattr(harness.driver("search"), "run")
    listed = harness.cell_metrics(harness.benchmark(str(root)), "new.cell")
    assert [m["name"] for m in listed["per_layer"]] == ["new_metric.cell"]
    assert [m["name"] for m in listed["end_to_end"]] == ["setup_s"]
    w = harness.Window(seconds=1.0, setup_s=2.0, values={"answer": 21})
    out = harness.metrics(harness.benchmark(str(root)), "new.cell", w, trace=True)
    assert out == {"new_metric.cell": {"value": 42.0, "unit": "ms"}}
