"""krylov_roofline.batch: the batched BiCGStab(1) iterations' compulsory bytes
(`roofline.bicgstab1_iteration_bytes`) times the traced requests'
iterations, over the published bandwidth, as a % of the traced device
seconds of the iteration's kernels (K1 and K5 stencils, K2, K13)."""
from otmb_bench import roofline
from otmb_bench.readers import roofline_share

KERNELS = ("stencil_kernel", "stencil_multi_kernel", "thomas_", "bicg1_", "alg_finish_kernel")


def read(run):
    return roofline_share(run, "krylov", roofline.bicgstab1_iteration_bytes, KERNELS)
