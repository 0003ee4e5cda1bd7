"""Set-up: from the process's start to the window's (loading, weights,
the program's start, warm-up; the first run in a checkout builds the
kernels too)."""


def read(b):
    return b.setup_s
