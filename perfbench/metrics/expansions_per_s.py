"""Search expansions served: 64-beam requests served in the window, each
counted by the share of its life (sending to answer) inside it, over the
window's seconds (host clock)."""


def read(w):
    n = w.values.get("expansions")
    return None if n is None else n / w.seconds
