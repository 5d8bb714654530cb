"""K6 and K9 on checkouts of the repository: time per call and device time
at the 1-degree shapes the density path gives them, the batches held to
their one-tracer runs and the T + R step to its plain composition bit for
bit, each batched launch's plan, and the registers and spills ptxas gave
each instantiation of the Redi kernel.

    python3 scripts/k6_probe.py [--order 0,1,1,0] [--quick] [ROOT ...]

Each ROOT (default: this checkout) runs in a process of its own that
imports `otmb_tpu_torch` from it and builds that checkout's kernels, so a
copy of the repository with `csrc/redi.cu` edited measures a variant of the
kernel beside the original in one call; `--order` lists the roots by index
(the default runs each once). Cases, on the Redi operator of chip_smoke's
hydrography at 360x300x50 (f32 unless said): K6 on one tracer (f32, bf16
coefficients, f64), K6 on a batch of B = 2, 4, 8 (f64 at B = 2 and 4), K5's
Euler step at B = 8, the T + R step of 8 tracers alone (K6's step mode,
`redi_kernel.step`, f32 and bf16 R; a checkout that has no step mode times
K6's accumulating entry instead), the whole T + R step through
`euler_propagate_multi(..., redi=R)` (and of 2 tracers) and of one tracer
through `euler_propagate`, and K9 on rank 0's 150x180x50 shard of a (2, 2) grid.
"ms" is CUDA events over back-to-back calls (median of 5), "device" each
case's kernels' time per call under `torch.profiler`
(`scripts/ab_redesign.py`'s helpers); "bound_ms" is the T + R step's
compulsory bytes at B = 8 (T's 7 legs, R's 15 fields and 2 planes, the wet
byte, each tracer read and written once) over 3.35 TB/s. One JSON line a
run, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
QUICK = False  # --quick: K6 f32 and bf16, batches of 4 and 8, the f32 accumulating entry, K9


def _ab():
    spec = importlib.util.spec_from_file_location("_k6_ab", HERE / "ab_redesign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(log: Path) -> dict:
    """ptxas's register and spill lines for each redi_kernel, by its
    demangled name where c++filt is found."""
    out, name, spill = {}, None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "redi_kernel" in name and "spill" in line:
            spill = line.strip()
        elif name and "redi_kernel" in name and "Used" in line:
            out[name] = f"{line.split(':', 1)[1].strip()}; {spill}"
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, check=True).stdout.split("\n")
        out = {n.split("(")[0]: v for n, v in zip(names, out.values())}
    except (OSError, subprocess.CalledProcessError):
        pass
    return out


def run_one(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import otmb_tpu_torch as P
    from otmb_tpu_torch import _build
    from otmb_tpu_torch.models import redi_kernel
    from otmb_tpu_torch.ops import stencil

    assert Path(P.__file__).resolve().is_relative_to(root.resolve()), P.__file__
    ab = _ab()
    S = ab._smoke()
    device = torch.device("cuda", 0)
    out = {"root": str(root), "ms": {}, "device": {}, "equal": {}, "plan": {}}
    timed = lambda name, fn, calls: ab._timed(out, name, fn, calls, "redi")

    ds, gm, idx = S.build_case(P, ab.NX, ab.NY, ab.NZ, "tripolar", torch.float64, device)
    wet, topo = idx.wet3d, gm.topology
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm).to(torch.float32)
    R64 = S.redi_of(P, gm, wet)
    R = R64.to(torch.float32)
    Rb = P.redi_operator_to_bf16(R)
    gen = torch.Generator(device=device).manual_seed(ab.SEED + 40)
    rand = lambda nb: torch.where(wet, torch.randn((nb,) + tuple(wet.shape), generator=gen,
                                                   device=device), 0.0)
    x, xs = rand(1)[0], rand(8)
    dt = 0.25 / (float(T.diag.abs().max()) + P.redi_max_rate(R))
    timed("K6 f32", lambda: P.redi_apply_fused(R, x), 50)
    timed("K6 bf16", lambda: P.redi_apply_fused(Rb, x), 50)
    if not QUICK:
        timed("K6 f64", lambda: P.redi_apply_fused(R64, x.double()), 50)
    for nb in ((4, 8) if QUICK else (2, 4, 8)):
        b = xs[:nb].contiguous()
        timed(f"K6 batch B={nb}", lambda: P.redi_apply_fused_multi(R, b), 20)
        got = P.redi_apply_fused_multi(R, b)
        out["equal"][f"B={nb}"] = all(torch.equal(got[m], P.redi_apply_fused(R, b[m]))
                                      for m in range(nb))
    if not QUICK:
        for nb in (2, 4):
            b64 = xs[:nb].double()
            timed(f"K6 f64 batch B={nb}", lambda: P.redi_apply_fused_multi(R64, b64), 20)
    fused = hasattr(redi_kernel, "step")
    # a checkout with K6's matvec mode names the step mode; before it, legs= did
    step = {"mode": "step"} if "mode" in inspect.signature(redi_kernel.plan).parameters else {}
    out["mode"] = "one launch" if fused else "two launches"
    y = torch.empty_like(xs)
    for name, op in (("f32", R),) if QUICK else (("f32", R), ("bf16", Rb)):
        want = stencil._plain(T, xs, topo, dt) + dt * P.redi_apply(op, xs)
        if fused:
            timed(f"T + R alone B=8 {name}", lambda: redi_kernel.step(T, op, xs, y, dt, True), 50)
            redi_kernel.step(T, op, xs, y, dt, True)
        else:
            acc = torch.zeros_like(xs)
            timed(f"K6 acc B=8 {name}", lambda: redi_kernel.accumulate(op, xs, acc, dt, True),
                  50)
            y = stencil._plain(T, xs, topo, dt)
            redi_kernel.accumulate(op, xs, y, dt, True)
        out["equal"][f"T + R {name}"] = bool(torch.equal(y, want))
    ab._timed(out, "K5 B=8", lambda: P.euler_step_multi(T, xs, dt, topo), 50, "stencil_multi")
    steps = 10
    out["ms"]["T + R step B=8"] = S.cuda_ms(
        lambda: P.euler_propagate_multi(T, xs, dt, steps, topo, redi=R), 5) / steps
    out["device"]["T + R step B=8"] = {
        k: v / steps for k, v in ab._device(
            lambda: P.euler_propagate_multi(T, xs, dt, steps, topo, redi=R), 5).items()}
    out["ms"]["T + R step B=1"] = S.cuda_ms(
        lambda: P.euler_propagate(T, x, dt, steps, topo, redi=R), 5) / steps
    out["device"]["T + R step B=1"] = {
        k: v / steps for k, v in ab._device(
            lambda: P.euler_propagate(T, x, dt, steps, topo, redi=R), 5).items()}
    x2 = xs[:2].contiguous()
    out["ms"]["T + R step B=2"] = S.cuda_ms(
        lambda: P.euler_propagate_multi(T, x2, dt, steps, topo, redi=R), 5) / steps
    got = P.euler_propagate_multi(T, xs, dt, 2, topo, redi=R)
    want = xs
    for _ in range(2):
        want = stencil._plain(T, want, topo, dt) + dt * P.redi_apply(R, want)
    out["equal"]["T + R propagation"] = bool(torch.equal(got, want))
    cells, plane = ab.NX * ab.NY * ab.NZ, ab.NX * ab.NY
    out["bound_ms"] = ((2 * 4 * 8 + 7 * 4 + 15 * 4 + 1) * cells + 2 * 4 * plane) / 3.35e9
    k9, shard = ab._k9_rank0(R, torch.where(wet, x, torch.nan), topo, device)
    timed(f"K9 {shard[0]}x{shard[1]}x{ab.NZ}", k9, 50)
    for nb in (1, 2, 4, 8):
        b = xs[:nb].contiguous()
        out["plan"][f"B={nb}"] = (redi_kernel.plan(R, b, True, legs=torch.float32, **step)
                                  if fused else redi_kernel.plan(R, b, True, acc=True))
    out["registers"] = registers(_build.library_path().with_suffix(".log"))
    return out


def main() -> int:
    global QUICK
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        QUICK = "--quick" in sys.argv
        print(json.dumps(run_one(Path(sys.argv[2]))), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("roots", nargs="*")
    args = ap.parse_args()
    roots = args.roots or [str(HERE.parent)]
    order = [int(n) for n in args.order.split(",")] if args.order else range(len(roots))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[k6] card {card}", flush=True)
    for n in order:
        proc = subprocess.run([sys.executable, __file__, "--one", str(Path(roots[n]).resolve())]
                              + (["--quick"] if args.quick else []), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(f"[k6] {proc.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
