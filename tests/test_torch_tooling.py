"""PyTorch port, tooling: ``utils/misc`` (``zip_strict``, ``set_logger``,
the test thread cap), ``utils/profiling`` (``SectionTimer``; ``device_trace``
writing a Chrome trace of CPU activity), ``scripts/data_stats`` (its log
lines identical to ``scripts/data_stats.py``'s) and
``scripts/convert_checkpoint`` (a ``CheckpointManager`` checkpoint to an HF
directory that loads bit-equal in the port and equal in the JAX package)."""

import importlib.util
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from reprover_tpu.models import hf_import as jhf
from reprover_tpu_torch.models import hf_import as thf
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.scripts import convert_checkpoint, data_stats
from reprover_tpu_torch.utils import SectionTimer, device_trace, set_logger, zip_strict
from reprover_tpu_torch.utils.checkpoint import CheckpointManager
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)


def test_zip_strict():
    assert list(zip_strict([1, 2], "ab")) == [(1, "a"), (2, "b")]
    with pytest.raises(AssertionError, match="length mismatch"):
        zip_strict([1, 2], [1])


def test_set_logger_levels():
    root = logging.getLogger()
    saved = root.level, list(root.handlers)
    try:
        set_logger(True)
        assert root.level == logging.DEBUG
        set_logger(False)
        assert root.level == logging.INFO
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]


def test_cap_cpu_threads():
    before = torch.get_num_threads()
    try:
        cap_cpu_threads(2)
        assert torch.get_num_threads() == 2
    finally:
        cap_cpu_threads(before)


def test_section_timer():
    timer = SectionTimer()
    for _ in range(2):
        with timer.section("slow"):
            time.sleep(0.02)
    with timer.section("fast"):
        pass
    with pytest.raises(RuntimeError):
        with timer.section("raises"):
            raise RuntimeError
    assert timer.counts == {"slow": 2, "fast": 1, "raises": 1}
    assert list(timer.summary())[0] == "slow" and timer.totals["slow"] >= 0.04


def test_device_trace_writes_a_cpu_trace(tmp_path):
    x = torch.randn(64, 64)
    with device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        (x @ x).sum()
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def _jax_data_stats():
    spec = importlib.util.spec_from_file_location("jax_data_stats",
                                                  os.path.join(REPO, "scripts", "data_stats.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_data_stats_lines_match_jax_script(toy_corpus_path, toy_dataset_dir, tmp_path,
                                           monkeypatch, capsys):
    """``main`` of both scripts in this process: the same log messages."""
    bench = tmp_path / "bench"
    (bench / "random").mkdir(parents=True)
    os.link(toy_corpus_path, bench / "corpus.jsonl")
    for split in ("train", "val", "test"):
        os.link(os.path.join(toy_dataset_dir, f"{split}.json"), bench / "random" / f"{split}.json")
    root = logging.getLogger()
    saved = root.level, list(root.handlers)
    try:
        monkeypatch.setattr(sys, "argv", ["data_stats", "--data-path", str(bench)])
        _jax_data_stats().main()
        want = [line.split(":", 2)[2] for line in capsys.readouterr().err.splitlines()]
        data_stats.main(["--data-path", str(bench)])
        got = [line.split(":", 2)[2] for line in capsys.readouterr().err.splitlines()]
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
    assert got == want
    assert got[0] == "number of files: 4" and len(got) == 10


def test_data_stats_cli_output_matches_jax_script(toy_corpus_path, toy_dataset_dir, tmp_path):
    """``python -m`` against ``python scripts/data_stats.py``: the same
    stderr, byte for byte."""
    bench = tmp_path / "bench"
    (bench / "random").mkdir(parents=True)
    os.link(toy_corpus_path, bench / "corpus.jsonl")
    for split in ("train", "val", "test"):
        os.link(os.path.join(toy_dataset_dir, f"{split}.json"), bench / "random" / f"{split}.json")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    runs = [subprocess.run(cmd + ["--data-path", str(bench)], env=env, cwd=REPO, check=True,
                           capture_output=True, text=True, timeout=120)
            for cmd in ([sys.executable, "scripts/data_stats.py"],
                        [sys.executable, "-m", "reprover_tpu_torch.scripts.data_stats"])]
    assert runs[1].stderr == runs[0].stderr and "number of tactics" in runs[0].stderr


@pytest.mark.parametrize("model_type", ["retriever", "generator"])
def test_convert_checkpoint_round_trip(tmp_path, model_type):
    """A tiny checkpoint as ``retrieval.main``/``generation.main fit`` save
    it (fused MLP, fp32 masters) -> HF dir; the port's ``load_hf_t5`` gives
    the checkpoint's tensors bit-equal, the JAX package's equal values."""
    cfg = tt5.T5Config(**TINY)
    params = tt5.fuse_mlp_params(tt5.init_params(cfg, torch.Generator().manual_seed(3)))
    encoder_only = model_type == "retriever"
    if encoder_only:
        params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}

    class State:
        step, optimizer = 7, None

    State.params = params
    src = str(tmp_path / "ckpts")
    CheckpointManager(src).save(7, State())
    hf_cfg_dir = tmp_path / "geometry"
    hf_cfg_dir.mkdir()
    (hf_cfg_dir / "config.json").write_text(json.dumps(thf.hf_config(cfg)))
    dst = str(tmp_path / "hf")
    convert_checkpoint.main([model_type, "--src", src, "--hf-config", str(hf_cfg_dir),
                             "--dst", dst])

    loaded, cfg2 = thf.load_hf_t5(dst, encoder_only=encoder_only)
    assert cfg2 == cfg
    loaded = tt5.fuse_mlp_params(loaded)
    flat = dict(_flat(params))
    got = dict(_flat(loaded))
    assert set(flat) <= set(got)
    for name, t in flat.items():
        assert torch.equal(got[name], t), name
    jparams, jcfg = jhf.load_hf_t5(dst, encoder_only=encoder_only)
    assert jcfg.d_model == cfg.d_model and jcfg.num_encoder_layers == cfg.num_encoder_layers
    jflat = dict(_flat_np(jparams))
    np.testing.assert_array_equal(jflat["encoder.rel_bias"], params["encoder"]["rel_bias"].numpy())
    np.testing.assert_array_equal(jflat["shared_embedding"], params["shared_embedding"].numpy())
    q = params["encoder"]["layers"]["attn"]["q"].numpy()
    np.testing.assert_array_equal(jflat["encoder.layers.attn.q"], q)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _flat_np(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_np(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)
