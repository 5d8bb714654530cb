"""How robust the 0.25-degree refined ideal age is to rounding-level changes
of its system, per checkout of the repository, on one card.

    python3 scripts/quarter_robustness.py --roots OLD NEW [--rates 1,1.000001,...] [--out FILE]

Each root runs in a process of its own that imports `otmb_tpu_torch` from
that checkout (building its kernels) and builds the 1440x1080x75 case of
`chip_smoke.py` once (host path, tripolar, seed 0, f32 T from K4). Then, for
each surface restoring rate in --rates (1.0 is the main path's; the others
move the surface diagonal by a few f32 ulps, the same problem up to
rounding), it solves the refined ideal age (tol 1e-8, BiCGStab(2) inner
solves) and records the wall seconds, the final residual, and each pass's
start defect, inner matvec pairs, stop reason and best recurrence residual.
The BiCGStab(2) recurrence in f32 at this size is sensitive to rounding, so
one run says little; the share of rates that reach the main path's bound
(1e-5) says how robust a checkout's engine is.
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
RATES = (1.0, 1.000001, 0.999999, 1.000002)


def _smoke():
    spec = importlib.util.spec_from_file_location("_rb_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root: Path, rates) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import otmb_tpu_torch as P

    assert Path(P.__file__).resolve().is_relative_to(root.resolve()), P.__file__
    C = _smoke()
    device = torch.device("cuda", 0)
    ds, gm, idx = C.build_case(P, *QUARTER, "tripolar", torch.float32, device)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    del ds
    out = {"root": str(root), "solves": []}
    for rate in rates:
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gamma, res = P.ideal_age(T, idx.wet3d, gm.topology, surface_rate=rate, tol=C.TOL_AGE,
                                 refine=True, algorithm="bicgstab2", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["solves"].append({
            "rate": rate, "wall_s": wall, "res": res, "ok": res <= C.TOL_QUARTER,
            "mean_yr": C.mean_years(gamma, gm.v3d, idx.wet3d),
            "passes": [[p["rel_start"], p.get("inner_iters"), p.get("inner_stop"),
                        p.get("inner_end_rel")] for p in stats["passes"]]})
        print(json.dumps(out["solves"][-1]), file=sys.stderr, flush=True)
        del gamma
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", type=Path)
    ap.add_argument("--rates", default=",".join(map(str, RATES)))
    ap.add_argument("--out", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    rates = [float(r) for r in args.rates.split(",")]
    if args.one is not None:
        print(json.dumps(run_one(args.one, rates)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[robustness] card {card}", flush=True)
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root.resolve()),
                               "--rates", args.rates], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        for s in runs[-1]["solves"]:
            print(f"[robustness] {root}: rate {s['rate']}: residual {s['res']:.3e} "
                  f"({'ok' if s['ok'] else 'MISSED 1e-5'}), {len(s['passes'])} passes, "
                  f"{s['wall_s']:.3f} s, mean {s['mean_yr']:.6f} yr; passes "
                  + " | ".join(f"{p[0]:.2e} {p[1]} {p[2]} {p[3] if p[3] is None else f'{p[3]:.2e}'}"
                               for p in s["passes"]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
