"""stencil_roofline.step: the batched Euler steps' compulsory bytes
(`roofline.euler_step_bytes`) times the traced steps, over the published
bandwidth, as a % of all traced device seconds (K5)."""
from otmb_bench import roofline
from otmb_bench.readers import roofline_share


def read(run):
    return roofline_share(run, "stencil", roofline.euler_step_bytes)
