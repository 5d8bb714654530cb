"""redi_roofline.redi: the T + R steps' compulsory bytes
(`roofline_neutral.neutral_step_bytes`) times the traced steps, over the
published bandwidth, as a % of all traced device seconds (K5 and K6's
accumulating launches)."""
from otmb_bench import roofline_neutral
from otmb_bench.readers import roofline_share


def read(run):
    params = run.work.get("neutral")
    if params is None:
        return None
    redi = params["redi_coef_bytes"]
    return roofline_share(run, "neutral", lambda shape, vec, coef, batch:
                          roofline_neutral.neutral_step_bytes(shape, vec, coef, batch, redi))
