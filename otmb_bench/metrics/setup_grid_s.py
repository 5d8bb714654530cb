"""setup_grid_s: seconds of set-up in the process's `makegridmetrics`,
`makeindices` and `facefluxesfrommasstransport` spans, the host-side grid
path, recorded before the trace (the recorder is always on)."""
from otmb_bench.spans import setup_grid_s


def read(run):
    return setup_grid_s(run)
