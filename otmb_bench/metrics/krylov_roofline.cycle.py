"""krylov_roofline.cycle: the BiCGStab(2) cycles' compulsory bytes
(`roofline.bicgstab2_cycle_bytes`) times the traced cycles, over the
published bandwidth, as a % of all traced device seconds (K3, K11, K12 and
the cycle's remaining kernels)."""
from otmb_bench import roofline
from otmb_bench.readers import roofline_share


def read(run):
    return roofline_share(run, "krylov_cycles", roofline.bicgstab2_cycle_bytes)
