"""idle_reading.solve: % of the traced stretch (over `idle_share.solve`'s
denominator) in which the device was idle while the innermost program span
on the host was `engine.read`: the engine or the refinement waiting on a
residual or a norm read back to the host."""
from otmb_bench.spans import idle_share_in


def read(run):
    return idle_share_in(run, "engine.read")
