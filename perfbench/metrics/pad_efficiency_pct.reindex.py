"""Share of the padded tokens the encoder ran that are real: the port's
``retriever.tokens_real`` counter over its ``retriever.tokens_padded``
(rows times each batch's padded length; ``counters()`` of
``reprover_tpu_torch/utils/profiling.py``). The program's counters are
cumulative, so this covers every re-index of the run: the warm-up, the
window and the traced shard. None where the program has no such counters."""

from reprover_tpu_torch.utils import profiling


def read(w):
    counters = getattr(profiling, "counters", None)
    c = counters() if counters else {}
    padded = c.get("retriever.tokens_padded", 0)
    return 100.0 * c.get("retriever.tokens_real", 0) / padded if padded else None
