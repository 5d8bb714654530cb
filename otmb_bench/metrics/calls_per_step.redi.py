"""calls_per_step.redi: launch-path calls (`_build.calls`) a T + R step:
the calls made inside the program's `euler_propagate_multi` spans that
carry `redi`, over their steps. 2.0 where a step is K5 and K6's
accumulating entry, 1.0 where one kernel does both."""
from otmb_bench.spans import program_spans


def read(run):
    recorded = program_spans()
    if recorded is None or recorded[1]:
        return None
    found = [s for s in recorded[0]
             if s.name == "euler_propagate_multi" and s.attrs.get("redi")]
    steps = sum(s.attrs.get("steps", 0) for s in found)
    if not steps:
        return None
    return sum(s.calls for s in found) / steps
