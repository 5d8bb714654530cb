"""K5 and K7 multi on one checkout: time per call and device time at the
shapes the main path gives them, each member held to K1 bit for bit, and
the registers and spills ptxas gave each instantiation of the batched
kernel.

    python3 scripts/k5_probe.py [ROOT ...]

Each ROOT (default: this checkout) runs in a process of its own that
imports `otmb_tpu_torch` from it and builds that checkout's kernels, so a
copy of the repository with `csrc/stencil.cu` edited measures a variant of
the kernel beside the original in one call. Cases: K1 and K5 (f32, B = 1,
2, 4, 8; f64 at B = 8) on the 1-degree T (360x300x50), K7 multi (B = 1, 4,
8) on rank 0's 150x180x50 shard of a (2, 2) grid, and K1 and K5 (B = 1, 4,
8) on random legs at 0.25 degrees (1440x1080x75). "ms" is CUDA events over
back-to-back calls (median of 5) and "device" the kernels' time per call
under `torch.profiler` (`scripts/ab_redesign.py`'s helpers). One JSON line
a root, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _ab():
    spec = importlib.util.spec_from_file_location("_k5_ab", HERE / "ab_redesign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(log: Path) -> dict:
    """ptxas's register and spill lines for each stencil_multi_kernel."""
    out, name, spill = {}, None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "stencil_multi_kernel" in name and "spill" in line:
            spill = line.strip()
        elif name and "stencil_multi_kernel" in name and "Used" in line:
            out[name] = f"{line.split(':', 1)[1].strip()}; {spill}"
    return out


def run_one(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import otmb_tpu_torch as P
    from otmb_tpu_torch import _build
    from otmb_tpu_torch.grid.topology import GridTopology
    from otmb_tpu_torch.ops.coeffs import StencilCoeffs

    assert Path(P.__file__).resolve().is_relative_to(root.resolve()), P.__file__
    ab = _ab()
    S = ab._smoke()
    device = torch.device("cuda", 0)
    out = {"root": str(root), "ms": {}, "device": {}}
    timed = lambda name, fn, calls: ab._timed(out, name, fn, calls, "stencil")

    def k5(c, xs, topo, name, calls):
        timed(name, lambda: P.stencil_apply_multi(c, xs, topo), calls)
        y = P.stencil_apply_multi(c, xs, topo)
        assert all(torch.equal(y[m], P.stencil_apply(c, xs[m], topo)) for m in range(len(xs)))

    ds, gm, idx = S.build_case(P, ab.NX, ab.NY, ab.NZ, "tripolar", torch.float32, device)
    T = P.assemble_T(ds.umo, ds.vmo, ds.mlotst, gm)
    topo, wet = gm.topology, idx.wet3d
    gen = torch.Generator(device=device).manual_seed(ab.SEED + 30)
    rand = lambda shape: torch.where(wet, torch.randn(shape, generator=gen, device=device), 0.0)
    x = rand(tuple(wet.shape))
    timed("K1 1deg f32", lambda: P.stencil_apply(T, x, topo), 50)
    for nb in (1, 2, 4, 8):
        xs = rand((nb,) + tuple(wet.shape))
        k5(T, xs, topo, f"K5 1deg f32 B={nb}", 50)
    k5(T.to(torch.float64), xs.double(), topo, "K5 1deg f64 B=8", 50)
    for nb in (1, 4, 8):
        timed(f"K7 multi B={nb} 150x180x50", ab._k7_rank0(T, x, xs[:nb].contiguous(), topo,
                                                          device)[1], 50)
    del ds, gm, idx, T, x, xs
    torch.cuda.empty_cache()
    nx, ny, nz = ab.QUARTER
    qtopo = GridTopology(kind="tripolar", nx=nx, ny=ny, nz=nz)
    legs = StencilCoeffs(*(torch.randn((nz, ny, nx), generator=gen, device=device)
                           for _ in StencilCoeffs._fields))
    xq = torch.randn((nz, ny, nx), generator=gen, device=device)
    timed("K1 quarter f32", lambda: P.stencil_apply(legs, xq, qtopo), 10)
    for nb in (1, 4, 8):
        k5(legs, torch.randn((nb, nz, ny, nx), generator=gen, device=device), qtopo,
           f"K5 quarter f32 B={nb}", 10)
    out["registers"] = registers(_build.library_path().with_suffix(".log"))
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(run_one(Path(sys.argv[2]))), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[k5] card {card}", flush=True)
    for root in sys.argv[1:] or [str(HERE.parent)]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(f"[k5] {proc.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
