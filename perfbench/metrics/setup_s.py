"""Seconds from the process's start until the window could open: imports,
the kernel library (built on a checkout's first run), the seeded weights,
the handler, the server and the warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s
