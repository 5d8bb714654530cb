"""batch_solve_s: window seconds over the batched steady-state solves (all
members to their stated residual) completed in it."""
from otmb_bench.readers import per_unit


def read(run):
    return per_unit(run)
