"""solve_s: window seconds over the steady-state solves (one field to its
stated residual) completed in it."""
from otmb_bench.readers import per_unit


def read(run):
    return per_unit(run)
