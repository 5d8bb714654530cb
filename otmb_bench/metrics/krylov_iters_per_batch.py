"""krylov_iters_per_batch: the batched Krylov engine's iterations per
request (all members in lockstep), from its `stats`, over every request of
the window."""
from otmb_bench.readers import mean_counter


def read(run):
    return mean_counter(run, "krylov_iters")
