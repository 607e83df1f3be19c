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


def test_tp1_waits_for_the_multi_gpu_slice(model, data_path, monkeypatch, capsys):
    """``--tp1`` (once a placeholder that raised until tensor-parallel
    serving was ported) serves the streaming cells through a 1 x 1 mesh, as
    the JAX driver does: ``main`` hands every cell a one-rank mesh, and a
    cell served through it runs every search's expansions, its line saying
    ``tp`` 1."""
    from reprover_tpu_torch.parallel.mesh import local_mesh

    meshes = []
    monkeypatch.setattr(sl, "make_data", lambda work: data_path)
    monkeypatch.setattr(sl, "run_cell", lambda *args, **kwargs: meshes.append(kwargs["mesh"]))
    sl.main(["--device", "cpu", "--tp1", "--tiny", "--workers", "2"])
    assert len(meshes) == 1 and meshes[0].size == 1
    monkeypatch.undo()
    row = sl.run_cell(model, data_path, 2, 0, 0.0, num_theorems=2, streaming=True, num_slots=2,
                      chunk_size=8, num_beams=8, env_latency_s=0.05, max_expansions=1,
                      device="cpu", profile_window_s=0, mesh=local_mesh())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tp"] == 1 and line["mode"] == "streaming"
    assert row["searched_nodes"] == [2, 2]


@pytest.mark.parametrize("streaming", [True, False])
def test_quiesced_service_dispatches_nothing(model, streaming):
    """While ``quiesced`` holds the service, a request queues and the
    service admits, runs and answers nothing; once the hold ends, the
    request is answered. The service load driver starts and stops its
    profiler under this hold."""
    import asyncio
    import threading
    import time

    from reprover_tpu_torch.prover import InferenceService, StreamingInferenceService

    if streaming:
        service = StreamingInferenceService(model, num_slots=2, num_beams=8, chunk_size=8,
                                            reorder_mode="gather")
    else:
        service = InferenceService(model, max_batch=2, batch_window_s=0.005)
    client = service.client()
    client.timeout_s = 30.0  # a failed case ends instead of waiting half an hour

    def ask() -> list:
        return asyncio.run(client.agenerate("1 + 1 = 2", "F.lean", "t", (1, 1), 8))

    service.start()
    try:
        assert ask()  # served before the hold (the engine is built)
        answers: list = []
        with service.quiesced(timeout_s=60.0):
            before = service.stats_snapshot()
            asker = threading.Thread(target=lambda: answers.append(ask()), daemon=True)
            asker.start()
            time.sleep(0.5)
            after = service.stats_snapshot()
            assert not answers and after["requests"] == before["requests"]
            if streaming:
                assert (after["chunks"], after["admissions"]) == (before["chunks"],
                                                                   before["admissions"])
        asker.join(timeout=60)
        assert answers and answers[0]
        assert service.stats_snapshot()["requests"] == before["requests"] + 1
    finally:
        service.stop()
