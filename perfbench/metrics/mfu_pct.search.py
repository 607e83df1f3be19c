"""Operations of the window's admissions (encoder and cross keys at the
padded source) and decode steps (every slot and beam), counted from the
shapes, over the window's seconds at the card's bf16 peak."""

from perfbench.counts import mfu_pct


def read(w):
    flops = w.values.get("flops")
    return mfu_pct(flops, w.seconds) if flops else None
