"""setup_density_s: seconds of set-up in the density path's own spans,
`rho_teos10`, `potential_density_slopes` (or `density_slopes`),
`add_bolus_transports` and `build_redi_operator`: each span's length less
its children's (self time), summed, so a span inside another counts once."""
from otmb_bench.spans import program_spans

DENSITY = ("rho_teos10", "potential_density_slopes", "density_slopes", "add_bolus_transports",
           "build_redi_operator")


def read(run):
    recorded = program_spans()
    if recorded is None or recorded[1]:
        return None
    spans = recorded[0]
    children = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    found = [s for s in spans if s.name in DENSITY]
    if not found:
        return None
    return 1e-9 * sum(s.end_ns - s.start_ns - children.get(s.id, 0) for s in found)
