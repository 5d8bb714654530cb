"""solve_p90_s: the 90th percentile (nearest rank) of every request's wall
seconds in the window."""
from otmb_bench.readers import p90


def read(run):
    return p90(run)
