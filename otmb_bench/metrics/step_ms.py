"""step_ms: window milliseconds over the Euler steps of the batch completed
in it."""
from otmb_bench.readers import per_unit


def read(run):
    return per_unit(run, 1e3)
