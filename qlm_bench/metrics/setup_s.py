"""Seconds from the process's start to the first arrival of the lead-in:
the kernels' load (their build on a checkout's first run), the weights
from the seed, the calibration, the warm-up of the cell's shapes."""


def read(run, qualifier=None):
    return run.setup_s
