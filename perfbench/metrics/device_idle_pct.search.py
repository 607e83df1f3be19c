"""Share of the traced window in which no kernel, copy or fill ran."""


def read(w):
    t = w.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t.get("window_s") else None
