"""krylov_roofline.redi_solve: the T - R BiCGStab(1) iterations' compulsory
bytes (`roofline_redi_solve.bicgstab1_redi_iteration_bytes`: T's iteration
and two reads of R's fields, planes and wet mask) times the traced
requests' iterations, over the published bandwidth, as a % of all traced
device seconds (K6's matvec mode, K2, K13, and the request's K4 and f64
defects)."""
from otmb_bench import roofline_redi_solve
from otmb_bench.readers import roofline_share


def read(run):
    params = run.work.get("krylov")
    if params is None or "redi_coef_bytes" not in params:
        return None
    redi = params["redi_coef_bytes"]
    return roofline_share(run, "krylov", lambda shape, vec, coef, batch:
                          roofline_redi_solve.bicgstab1_redi_iteration_bytes(
                              shape, vec, coef, batch, redi))
