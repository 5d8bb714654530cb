"""Same-card A/B of the 0.25-degree BiCGStab(2) engine between checkouts of
the repository: the refined ideal age, one cycle's device time by kernel
class, and the fixed-work batched solve.

    python3 scripts/ab_cycle.py --roots OLD NEW --order 0,1,1,0 [--out FILE]

Every run is a process of its own that imports `otmb_tpu_torch` from one
checkout (which builds that checkout's kernels from its `csrc/`) and
measures on the current CUDA device, at 1440x1080x75 (tripolar, seed 0, the
host-built case of `chip_smoke.py`, f32 T from K4):

  * the refined ideal age (tol 1e-8, BiCGStab(2) inner solves on K3): wall
    seconds, passes, inner matvec pairs, residual and volume-weighted mean
    age, so that runs can be seen to compute the same bits;
  * one BiCGStab(2) cycle of that system (fused, from its initial state):
    ms per cycle with CUDA events over 5 back-to-back cycles, and under
    `torch.profiler` the device ms per cycle of K3, of K11 and K12 (the
    cycle's algebra kernels, where the checkout has them), of the other
    elementwise kernels (addcmul, where, the scalar algebra), of the dots
    (cuBLAS and reductions), and in all ("busy"), with the kernel count;
  * the fixed-work batched solve of 4 latitude-band dyes (150 matvec pairs,
    K5 + batched K2): ms per member-pair, wall over pairs x members.

The order lists the roots by index; "0,1,1,0" runs OLD, NEW, NEW, OLD. Each
run prints one JSON line; the calling process prints them all and the card,
and writes them to --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
QUARTER = (1440, 1080, 75)
CYCLES = 5  # cycles per timed or traced window
PAIRS = 150  # matvec pairs of the fixed-work batched solve
BANDS = 4


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (its helpers)."""
    spec = importlib.util.spec_from_file_location("_ab_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_class(name: str) -> str:
    """The class of a kernel in a cycle's trace, by its name."""
    if "krylov_kernel" in name or "krylov_dot_finish" in name:
        return "K3"
    if "polish_sums" in name or ("alg_finish" in name and ", 5>" in name):
        return "K11"
    if "polish_update" in name or "alg_finish" in name:
        return "K12"
    if "dot" in name.lower() or "reduce" in name.lower() or "gemv" in name.lower():
        return "dots"
    return "elementwise"


def run_one(root: Path, device=None) -> dict:
    """Every measurement of one checkout (see the module docstring)."""
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import otmb_tpu_torch as P
    from otmb_tpu_torch.models import solvers as S

    assert Path(P.__file__).resolve().is_relative_to(root.resolve()), P.__file__
    C = _smoke()
    device = torch.device("cuda", 0) if device is None else device
    out = {"root": str(root)}
    nx, ny, nz = QUARTER
    t0 = time.perf_counter()
    ds, gm, idx = C.build_case(P, nx, ny, nz, "tripolar", torch.float32, device)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    del ds
    topo, wet = gm.topology, idx.wet3d

    # the refined ideal age
    stats = {}
    t0 = time.perf_counter()
    gamma, res = P.ideal_age(T, wet, topo, tol=C.TOL_AGE, refine=True, algorithm="bicgstab2",
                             stats=stats)
    torch.cuda.synchronize()
    out["age_s"] = time.perf_counter() - t0
    out["age_res"] = res
    out["age_passes"] = stats["refinements"]
    out["age_pairs"] = sum(p.get("inner_iters") or 0 for p in stats["passes"])
    out["age_mean_yr"] = C.mean_years(gamma, gm.v3d, wet)
    del gamma
    torch.cuda.empty_cache()

    # one cycle: CUDA events, then its kernels by class under torch.profiler
    sys_ = S._system(T, torch.float32, topo, extra_diag=C.surface_mask(wet, torch.float32))
    from otmb_tpu_torch.ops.krylov import krylov_scratch

    step = S._fused_step(sys_, krylov_scratch(*sys_.m_legs, factor=sys_.factor))
    state = S._initial_state(sys_, "bicgstab2", wet.float())
    state = S._bicgstab2_cycles(sys_, step, state, 2)  # past the first cycle's zeros
    out["cycle_ms"] = C.cuda_ms(lambda: S._bicgstab2_cycles(sys_, step, state, CYCLES),
                                1) / CYCLES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        S._bicgstab2_cycles(sys_, step, state, CYCLES)
        torch.cuda.synchronize()
    classes, kernels = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(("Memcpy", "Memset")):
            continue
        kernels += 1
        key = _kernel_class(e.name)
        classes[key] = classes.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / CYCLES
    out["cycle_device_ms"] = classes
    out["cycle_busy_ms"] = sum(classes.values())
    out["cycle_algebra_ms"] = out["cycle_busy_ms"] - classes.get("K3", 0.0)
    out["cycle_kernels"] = kernels / CYCLES
    del sys_, step, state
    torch.cuda.empty_cache()

    # the fixed-work batched solve
    bs, surf = C.bands_rhs(wet, BANDS)
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, res = P.solve_shifted_chunked_multi(T, bs, topo, extra_diag=surf, tol=1e-30,
                                            maxiter=PAIRS, early_stop=False,
                                            algorithm="bicgstab2", stats=st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["batched_ms_per_member_pair"] = wall * 1e3 / (BANDS * st["iters"])
    out["batched_res"] = res.tolist()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", type=Path)
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(run_one(args.one)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[ab] card {card}", flush=True)
    runs = []
    for i in map(int, args.order.split(",")):
        root = args.roots[i].resolve()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["wall_s"] = time.perf_counter() - t0
        runs.append(run)
        print(f"[ab] {json.dumps(run)}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
