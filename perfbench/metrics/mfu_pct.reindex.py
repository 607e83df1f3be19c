"""Encoder operations of the premises embedded in the window at their
batches' padded lengths, over the window's seconds at the card's bf16 peak."""

from perfbench.counts import mfu_pct


def read(w):
    flops = w.values.get("flops")
    return mfu_pct(flops, w.seconds) if flops else None
