"""The retrieval layer's readers (``prep_us_per_premise.reindex``,
``pad_efficiency_pct.reindex``) against a registry of the port's spans and
counters filled by hand: the right value, reported on the cell's traced
line; None where a count is 0, and where the program has no counters."""

import pytest

from perfbench import harness
from reprover_tpu_torch.utils import profiling

READERS = ("prep_us_per_premise.reindex", "pad_efficiency_pct.reindex")


@pytest.fixture
def registry(monkeypatch):
    reg = profiling.SectionTimer()
    monkeypatch.setattr(profiling, "REGISTRY", reg)
    return reg


def _fill(reg, prepared=4096, serialize_s=0.72, tokenize_s=0.11, real=844, padded=1000):
    reg.totals.update({"retriever.serialize": serialize_s, "retriever.tokenize": tokenize_s,
                       "retriever.encode": 9.0})
    reg.counts.update({"retriever.serialize": 3, "retriever.tokenize": 3, "retriever.encode": 8})
    reg.tallies.update({"retriever.premises_prepared": prepared, "retriever.tokens_real": real,
                        "retriever.tokens_padded": padded})


def _window():
    return harness.Window(seconds=51.0, setup_s=15.0)


def test_perfbench_retrieval_readers_read_the_registry(registry):
    _fill(registry)
    w = _window()
    assert harness.reader("prep_us_per_premise.reindex")(w) == pytest.approx(
        1e6 * (0.72 + 0.11) / 4096)
    assert harness.reader("pad_efficiency_pct.reindex")(w) == pytest.approx(84.4)
    line = harness.metrics(harness.benchmark(), "retriever.reindex", w, trace=True)
    assert line == {"prep_us_per_premise.reindex": {"value": pytest.approx(202.63671875),
                                                    "unit": "us/premise"},
                    "pad_efficiency_pct.reindex": {"value": pytest.approx(84.4), "unit": "%"}}
    assert harness.metrics(harness.benchmark(), "retriever.reindex", w, trace=False).keys() == {
        "setup_s"}


@pytest.mark.parametrize("name", READERS)
def test_perfbench_retrieval_readers_none_at_zero(registry, name):
    assert harness.reader(name)(_window()) is None
    _fill(registry, prepared=0, padded=0)
    assert harness.reader(name)(_window()) is None


@pytest.mark.parametrize("name", READERS)
def test_perfbench_retrieval_readers_none_without_counters(registry, monkeypatch, name):
    """A program without ``counters()`` (before it had spans) reads None."""
    _fill(registry)
    monkeypatch.delattr(profiling, "counters")
    assert harness.reader(name)(_window()) is None
