"""idle_issuing.solve: % of the traced stretch (over `idle_share.solve`'s
denominator) in which the device was idle while the innermost program span
on the host was `engine.steps`: the engine issuing its iterations, which
read nothing back (ops/ wrappers, `_build.launch`)."""
from otmb_bench.spans import idle_share_in


def read(run):
    return idle_share_in(run, "engine.steps")
