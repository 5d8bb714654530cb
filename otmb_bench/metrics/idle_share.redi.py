"""idle_share: % of the traced stretch of the window in which no device
operation ran (1 - the union of the operations' intervals / the stretch),
both from one torch.profiler trace."""
from otmb_bench.readers import idle_share


def read(run):
    return idle_share(run)
