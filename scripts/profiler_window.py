"""How often `torch.profiler` reports no kernel for a window around a
launch through the port's ctypes entry points, with and without host time
at the window's ends (tests/test_torch_cuda.py's `_cuda_events` takes such
a window again).

    python3 scripts/profiler_window.py [--windows 1000] [--out FILE]

On the current CUDA device, one process: K3 (`fused_krylov_step`, f64,
96x9x70 tripolar, combine and dot; a single launch of a few microseconds, as
in tests/test_torch_cuda.py::test_k3_tiles_and_strips_equal_composition)
inside `--windows` profiling windows of each kind, counting the windows in
which the profiler reports no `krylov_kernel`:

  * "bare": the window holds the call and `torch.cuda.synchronize()` only;
  * "padded": the same, with PAD_S of host time (`time.sleep`) before the
    call and after the synchronize, still inside the window.

For each lost window it keeps the CUDA events the profiler did report.
Prints one JSON line with the card and the counts.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PAD_S = 2e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=1000)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import otmb_tpu_torch as P
    from otmb_tpu_torch.ops import krylov

    if not torch.cuda.is_available():
        print("profiler_window: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    topo = P.GridTopology("tripolar", 70, 9, 96)
    gen = torch.Generator(device=device).manual_seed(0)
    rand = lambda: torch.randn((96, 9, 70), generator=gen, device=device, dtype=torch.float64)
    a = P.StencilCoeffs(*(rand().abs() + (4.0 if leg == "diag" else 0.0)
                          for leg in P.StencilCoeffs._fields))
    m = (a.bottom, a.diag, a.top)
    x1, x2, rhat = rand(), rand(), rand()
    scratch = krylov.krylov_scratch(*m)
    call = lambda: P.fused_krylov_step(a, *m, x1, x2, 0.5, rhat, topo, scratch=scratch)
    call()
    torch.cuda.synchronize()
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip(), "windows": args.windows}
    for kind in ("bare", "padded", "bare"):
        lost, seen_in_lost = 0, {}
        for _ in range(args.windows):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                if kind == "padded":
                    time.sleep(PAD_S)
                call()
                torch.cuda.synchronize()
                if kind == "padded":
                    time.sleep(PAD_S)
            names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            if not any("krylov_kernel" in n for n in names):
                lost += 1
                for n in names:
                    key = n.split("(")[0][-60:]
                    seen_in_lost[key] = seen_in_lost.get(key, 0) + 1
        out.setdefault(kind, []).append({"lost": lost, "seen_in_lost": seen_in_lost})
        print(f"[profiler_window] {kind}: {lost} of {args.windows} windows without K3",
              flush=True)
    line = json.dumps(out)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
