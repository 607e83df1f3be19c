"""Premises embedded in the window over its seconds (host clock)."""


def read(w):
    n = w.values.get("premises")
    return None if n is None else n / w.seconds
