"""host_us_per_call.solve: host microseconds an entry call while the engine
issues its iterations: the summed length of the `engine.steps` spans that
lie inside the traced stretch over the C entry calls made in them
(`_build.calls`)."""
from otmb_bench.spans import host_us_per_call


def read(run):
    return host_us_per_call(run)
