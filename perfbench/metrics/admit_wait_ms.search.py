"""Mean wait of a request from its arrival at the service to its slot
(``admit_wait / admissions`` over the window)."""


def read(w):
    wait, n = w.delta("admit_wait"), w.delta("admissions")
    return 1e3 * wait / n if n else None
