"""idle_rest.solve: `idle_share.solve` less `idle_issuing.solve` and
`idle_reading.solve`: the device idle under every other program span (the
refinement's defect, `assemble_T`, the engine between its parts), under
none (the harness between requests), and at the stretch's edges."""
from otmb_bench.spans import idle_rest


def read(run):
    return idle_rest(run, ("engine.steps", "engine.read"))
