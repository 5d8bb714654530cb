"""calls_per_iter.solve: C entry calls (`_build.calls`) a matvec pair in the
`engine.steps` spans that lie inside the traced stretch: their calls over
their iterations."""
from otmb_bench.spans import calls_per_iter


def read(run):
    return calls_per_iter(run)
