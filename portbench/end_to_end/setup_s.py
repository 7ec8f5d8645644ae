"""Seconds from the process's start to the window's open: imports, the
CUDA libraries, the plate, and each worker's warm-up images."""


def read(run):
    return run.setup_s
