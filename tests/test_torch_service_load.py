"""PyTorch port, the service load driver
(``reprover_tpu_torch/benchmarks/service_load.py``) on the CPU with a tiny
T5 (``--device cpu``): two spawned prover workers, two theorems, two
expansions each and a 0.05 s environment latency, through the streaming and
the coalescing service. Every search runs its expansions (``max_expansions``
+ 1: the search stops once it has passed the limit, a quirk of the
reference that the JAX package keeps), and the JSON line
carries the JAX driver's keys (``benchmarks/service_load.py:154-176``)."""

import json

import pytest

from reprover_tpu_torch.benchmarks import service_load as sl
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

JAX_KEYS = {"mode", "beams", "env_latency_s", "tp", "quantize", "buckets", "slots", "chunk",
            "workers", "max_batch", "window_ms", "theorems", "expansions", "wall_s",
            "expansions_per_s", "serve_window_s", "expansions_per_s_serving", "stats"}


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    return sl.make_data(str(tmp_path_factory.mktemp("service_load")))


@pytest.fixture(scope="module")
def model():
    return sl.make_model("cpu", tiny=True)


@pytest.mark.parametrize("streaming", [True, False])
def test_run_cell_on_cpu(model, data_path, streaming, capsys):
    row = sl.run_cell(model, data_path, 2, 2, 5.0, num_theorems=2, streaming=streaming,
                      num_slots=2, chunk_size=8, num_beams=8, env_latency_s=0.05,
                      max_expansions=2, device="cpu", profile_window_s=0.5 if streaming else 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JAX_KEYS <= set(line)
    assert line["mode"] == ("streaming" if streaming else "coalescing")
    assert line["theorems"] == 2 and line["expansions"] == 6
    assert row["searched_nodes"] == [3, 3]
    assert line["stats"]["requests"] == 6
    if streaming:
        assert line["stats"]["admissions"] == 6
        assert line["device_busy_share"] == 0.0 and line["trace_kernels"] == {}


def test_latency_is_per_tactic():
    """The always-progress session waits 0.5-1.5 x the latency per tactic
    and always returns a fresh open state."""
    env = sl.LoadEnvironment(latency_s=0.0)

    class Thm:
        full_name = "t"

    with env.enter(Thm()) as (session, state):
        a = session.run_tac(state, "simp")
        b = session.run_tac(state, "rfl")
    assert a.pp != b.pp and a.pp.startswith(state.pp[:16])


def test_tp1_waits_for_the_multi_gpu_slice():
    with pytest.raises(NotImplementedError, match="multi"):
        sl.main(["--device", "cpu", "--tp1"])
