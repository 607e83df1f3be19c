"""Share of engine slots decoding, sampled by the service at each run
dispatch (``slot_busy / slot_cap`` over the window)."""


def read(w):
    busy, cap = w.delta("slot_busy"), w.delta("slot_cap")
    return 100.0 * busy / cap if cap else None
