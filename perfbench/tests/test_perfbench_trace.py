"""Busy and idle arithmetic on synthetic traces, and the tail statistics."""

import numpy as np
import pytest

from perfbench import stats, trace


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_perfbench_union_and_gaps():
    merged = trace.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert merged == [(0, 3), (5, 9)]
    assert trace.gaps(merged, (-1, 12)) == [(-1, 0), (3, 5), (9, 12)]
    assert trace.busy_seconds([(0, 2e6), (1e6, 3e6)]) == pytest.approx(3.0)


def test_perfbench_reduce_synthetic_trace():
    events = [
        _ev(trace.WINDOW, "user_annotation", 100.0, 1000.0),   # window 100..1100 us
        _ev("gemm", "kernel", 50.0, 100.0),                    # clipped to 100..150
        _ev("gemm", "kernel", 200.0, 100.0),                   # 200..300
        _ev("attn_fwd_kernel", "kernel", 250.0, 150.0),        # overlaps: union 200..400
        _ev("Memcpy DtoH", "gpu_memcpy", 1000.0, 200.0),       # clipped to 1000..1100
        _ev("aten::topk", "cpu_op", 140.0, 100.0),             # host during gap 150..200
        _ev("cudaStreamSynchronize", "cuda_runtime", 400.0, 550.0),  # host during 400..950
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((50 + 200 + 100) * 1e-6)
    ops = dict(r["device_ops"])
    assert ops["gemm"] == pytest.approx(150e-6)
    assert ops["attn_fwd_kernel"] == pytest.approx(150e-6)
    idle = dict(r["idle_gaps"])
    assert idle["aten::topk"] == pytest.approx(50e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(600e-6)
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])


def test_perfbench_reduce_without_window_is_empty():
    assert trace.reduce([_ev("gemm", "kernel", 0.0, 1.0)]) == {}


def test_perfbench_host_at_innermost():
    starts, ops = trace.host_ops([_ev("outer", "cpu_op", 0.0, 100.0),
                                  _ev("inner", "cpu_op", 10.0, 20.0)])
    assert trace.host_at(15.0, starts, ops) == "inner"
    assert trace.host_at(50.0, starts, ops) == "outer"
    assert trace.host_at(150.0, starts, ops) == "host: python"


@pytest.mark.parametrize("q", [50, 90, 95])
def test_perfbench_percentile_matches_numpy(q):
    xs = np.random.default_rng(0).lognormal(size=137).tolist()
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_perfbench_p90_of_samples():
    assert stats.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)



def test_perfbench_served_in_counts_shares_of_lives():
    from perfbench.drivers.search import Request, served_in

    reqs = [Request(0, "", sent=0.0, done=4.0),        # half inside [2, 10]
            Request(1, "", sent=3.0, done=5.0),        # all inside
            Request(2, "", sent=9.0, done=13.0),       # a quarter inside
            Request(3, "", sent=11.0, done=12.0),      # after the window
            Request(4, "", sent=3.0, done=6.0, error="x")]  # failed: not served
    assert served_in(reqs, 2.0, 10.0) == pytest.approx(0.5 + 1.0 + 0.25)
