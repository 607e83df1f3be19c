"""The stepwise engine's time a step: the window's milliseconds over the
steps the service's ``steps`` counter added in it."""


def read(w):
    steps = w.delta("steps")
    return 1e3 * w.seconds / steps if steps else None
