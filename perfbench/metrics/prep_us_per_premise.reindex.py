"""Host microseconds a premise spends being prepared for the encoder: the
port's ``retriever.serialize`` and ``retriever.tokenize`` spans' seconds
over its ``retriever.premises_prepared`` counter (``counters()`` of
``reprover_tpu_torch/utils/profiling.py``). The program's counters are
cumulative, so this covers every re-index of the run: the warm-up, the
window and the traced shard. None where the program has no such counters."""

from reprover_tpu_torch.utils import profiling


def read(w):
    counters = getattr(profiling, "counters", None)
    c = counters() if counters else {}
    n = c.get("retriever.premises_prepared", 0)
    seconds = c.get("retriever.serialize.seconds", 0.0) + c.get("retriever.tokenize.seconds", 0.0)
    return 1e6 * seconds / n if n else None
