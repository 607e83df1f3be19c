"""Set-up: process start to the window's start (loading, weights, warm-up,
on a first run in a checkout the kernels' build), by the host's clock."""


def read(w):
    return w.setup_s
