"""krylov_iters_per_solve: the Krylov engine's iterations per request (the
inner iterations summed over the refinement's passes, or the batch's
iterations), from its `stats`, over every request of the window."""
from otmb_bench.readers import mean_counter


def read(run):
    return mean_counter(run, "krylov_iters")
