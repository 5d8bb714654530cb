"""cycle_ms: window milliseconds over the Krylov cycles completed in it."""
from otmb_bench.readers import per_unit


def read(run):
    return per_unit(run, 1e3)
