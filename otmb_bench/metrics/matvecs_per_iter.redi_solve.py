"""matvecs_per_iter.redi_solve: runs of K6's matvec mode over Krylov
iterations. The entry reads the program's launch counter (`_build.calls` of
`models.redi_kernel.APPLY_ENTRIES`: each run, eager or inside a replay of
the graphed BiCGStab(1) iteration) around each request; this is their sum
over the window's requests over their inner iterations. 2.0 where each of
an iteration's two matvecs is one K6 launch; each pass's final residual
and each f64 defect add one."""


def read(run):
    found = [r for r in run.window.records if "k6_matvecs" in r.counters]
    iters = sum(r.counters.get("krylov_iters", 0) for r in found)
    if not found or iters <= 0:
        return None
    return sum(r.counters["k6_matvecs"] for r in found) / iters
