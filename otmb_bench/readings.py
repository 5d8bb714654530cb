"""Readings for setting a cell's limits: the cell run on many seeds in one
process, as the program or as its control (`--control 1`), one JSON line
per seed with every number the check compares, the result's metrics and
the counters of its requests.

    python3 -m otmb_bench.readings --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control 1] [--vary-case 1] [--out <file>.jsonl]

A limit lies above the largest reading of the program's seeds and below
the smallest of the control's (`workloads/<cell>.json`); this script takes
the readings and sets nothing. The numbers are read whatever the limits
are. A traffic mix that fixes its case (`case_seed`) reads one case on
every seed; `--vary-case 1` draws the case from each seed instead, so that
the readings span many seafloors and flows.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--vary-case", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from . import run as R
    from . import spec as S

    if not torch.cuda.is_available():
        print("otmb_bench.readings: no CUDA device", file=sys.stderr)
        return 2
    spec = S.load(args.workload)
    # a limit of inf reads each number whatever it is
    spec.workload = dict(spec.workload, limits={k: math.inf for k in spec.workload["limits"]})
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        details = {}
        if args.vary_case:
            spec.traffic = dict(spec.traffic, case_seed=seed)
        res = R.run(spec, seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                    control=bool(args.control), details=details)
        recs = details["window"].records
        line = json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                           "case_seed": spec.traffic.get("case_seed", seed),
                           "wall_s": time.perf_counter() - t0,
                           "numbers": {k: v["value"] for k, v in res["checks"].items()},
                           "attempted": res["attempted"], "failed": res["failed"],
                           "metrics": res["metrics"], "device": res["device"],
                           "window_s": details["window"].seconds,
                           "setup_split": details["setup_split"],
                           "iters": [r.counters.get("krylov_iters") for r in recs],
                           "walls": [round(r.wall_s, 5) for r in recs],
                           "breakdown": res.get("breakdown")})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
