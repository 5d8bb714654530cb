"""Run one cell of the benchmark once, on the CUDA devices of this machine.

    python3 -m otmb_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `otmb_bench/` and
the program, `otmb_tpu_torch/`. A run makes the cell's raw inputs from the
seed, builds the case through the program's public path and warms the
cell's shapes with one request (set-up), then sends requests back to back
for `--seconds` (the window), then checks the sampled answers and what
set-up derived against the plain reference. It prints each number compared
beside its limit as the last lines of standard error, and as the last line
of standard output one JSON object: `correct`, `attempted`, `failed`,
`metrics` (with --trace 0 the cell's end-to-end metrics, with --trace 1
its per-layer ones, from a `torch.profiler` trace of the first stretch of
the window), `device`, with --trace 1 `breakdown`, and last `checks`.

It exits 2 without a result where CUDA or the cell's cards are missing or
the program cannot be imported, and 3 where a JAX module was loaded.
"""

import time

_T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "otmb_tpu")
TRACE_TRIES = 3
TRACE_SECONDS = 3.0  # the traced stretch at the window's start


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must never load,
    compared whole (`otmb_tpu_torch` is not `otmb_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class RunView:
    """What a metric's reader sees."""

    window: object  # window.Window
    setup_s: float
    work: dict  # the entry's byte-count parameters, by the kind of work
    kind: str  # the card's name


def sample_indices(seed: int, workload: dict) -> set:
    """The requests the check keeps besides the last: `samples` indices
    drawn from the seed among the first `sample_from`."""
    import numpy as np

    n, k = workload["sample_from"], workload["samples"]
    return {int(i) for i in np.random.default_rng([seed, 7]).choice(n, size=min(k, n),
                                                                      replace=False)}


class _Tracer:
    """Runs the profiler over the window's first `seconds` of requests and
    keeps the device operations; a stretch that records no device
    operation is taken again over the next requests."""

    def __init__(self, seconds: float, sync, clock):
        self.seconds, self.sync, self.clock = seconds, sync, clock
        self.prof, self.records, self.tries, self.trace = None, [], 0, None

    def wrap(self, request):
        def traced(i):
            if self.prof is None and self.trace is None:
                self.start()  # a retake
            rec = request(i)
            if self.prof is not None:
                rec.traced = True
                self.records.append(rec)
                self.sync()
                if self.clock() - self.t0 >= self.seconds:
                    self.stop()
            return rec

        return traced

    @staticmethod
    def warm(sync):
        """Start and stop the profiler once, outside the window: its first
        start in a process takes seconds."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            sync()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.sync()
        self.t0, self.records = self.clock(), []

    def stop(self):
        from .window import Trace, device_ops

        if self.prof is None:
            return
        self.sync()
        span = self.clock() - self.t0
        self.prof.__exit__(None, None, None)
        ops = device_ops(self.prof)
        self.prof = None
        self.tries += 1
        if ops or self.tries >= TRACE_TRIES:
            self.trace = Trace(ops, span)
        else:
            for rec in self.records:
                rec.traced = False


def run(spec, seed: int, seconds: float, trace: bool, device, control: bool = False,
        t_start: float | None = None, clock=time.perf_counter,
        details: dict | None = None) -> dict:
    """One run of a cell (see the module docstring); returns the result.
    `details`, if a dict, receives the window and every number compared."""
    import torch

    from . import case as cases
    from . import check as C
    from . import program
    from . import spec as S
    from . import window as W

    t_run = clock()
    t_start = t_run if t_start is None else t_start
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    cfg = spec.config
    g = cfg["grid"]
    # a traffic mix whose work depends on the data fixes its case, so that
    # every seed sends the same work (in an order the seed draws)
    case_seed = spec.traffic.get("case_seed", seed)
    raw = cases.raw_case(g["nx"], g["ny"], g["nz"], cfg["topology"], case_seed, device)
    sync()
    t_case = clock()
    prog = S.entry(spec.traffic).Program(
        program.Context(raw, cfg, spec.traffic, seed, device, control))
    t_setup = clock()
    prog.request(0)  # warm-up: the cell's shapes, its kernels built or loaded
    sync()
    t_warm = clock()
    setup_s = t_warm - t_start
    split = {"to_run": t_run - t_start, "case": t_case - t_run, "program_setup": t_setup - t_case,
             "warm_request": t_warm - t_setup}

    sample = sample_indices(seed, spec.workload)
    kept, last = {}, {}

    def request(i):
        rec, answer = prog.request(i)
        if i in sample:
            kept[i] = answer
        last.clear()
        last[i] = answer
        return rec

    tracer = None
    if trace:
        _Tracer.warm(sync)
        tracer = _Tracer(TRACE_SECONDS, sync, clock)
        tracer.start()
    window = W.closed_loop(tracer.wrap(request) if tracer else request, seconds, sync, clock)
    if tracer:
        tracer.stop()
        window.trace = tracer.trace
    kept.update(last)
    last.clear()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()

    numbers = prog.check(kept, C.Reference(raw))
    failed = sum(not r.ok for r in window.records)
    if hasattr(prog, "failed"):
        failed += prog.failed(kept)
    numbers["failed"] = failed
    limits = dict(spec.workload["limits"], failed=0)
    checks = {k: {"value": _plain(numbers.get(k, math.nan)), "limit": v}
              for k, v in limits.items()}
    correct = all(numbers.get(k, math.nan) <= v for k, v in limits.items())

    view = RunView(window, setup_s, prog.work,
                   torch.cuda.get_device_name(device) if cuda else "cpu")
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = S.reader(m["name"])(view)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": view.kind,
           "count": spec.cell.get("chips", 1), "memory_peak_bytes": peak,
           "power_limit_w": _power_limit() if cuda else None}
    result = {"correct": correct, "attempted": len(window.records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and window.trace is not None:
        ops = window.trace.ops
        dev["busy_s"] = W.union_seconds(ops)
        dev["window_s"] = window.trace.span_s
        result["breakdown"] = {"device_ops": W.busiest(ops), "idle_gaps": W.idle_gaps(ops)}
    result["checks"] = checks
    if details is not None:
        details.update(window=window, numbers=numbers, setup_split=split)
    return result


def _plain(v):
    """A check's number for JSON: non-finite values as strings."""
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def _power_limit():
    """The card's power limit in W by nvidia-smi, None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _k10_rate(device) -> float | None:
    """The many-stream copy rate (GB/s) K10 measures, for the rooflines'
    context; None where it fails."""
    try:
        from otmb_tpu_torch.utils.profiling import probe_gbps

        return probe_gbps(device)
    except RuntimeError:
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    # Bytecode is a compile cache like the kernels': kept inside the checkout,
    # written by the first run and read by the later ones, also where the
    # environment forbids writing it beside the sources (PYTHONDONTWRITEBYTECODE);
    # compiling torch's sources from scratch took 6 s of every set-up.
    sys.pycache_prefix = str(cache / "pyc")
    sys.dont_write_bytecode = False

    from . import spec as S

    spec = S.load(args.workload)
    marks = {"start": _T0, "harness": time.perf_counter()}
    import torch

    marks["torch"] = time.perf_counter()
    chips = spec.cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"otmb_bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    marks["cuda_check"] = time.perf_counter()
    try:
        import otmb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"otmb_bench: cannot import the program otmb_tpu_torch: {e}", file=sys.stderr)
        return 2
    marks["program"] = time.perf_counter()
    device = torch.device("cuda", 0)
    details = {}
    result = run(spec, args.seed, args.seconds, bool(args.trace), device, t_start=_T0,
                 details=details)
    found = forbidden_modules()
    if found:
        print(f"otmb_bench: modules loaded that the run must not load: {found}", file=sys.stderr)
        return 3
    if args.trace:
        rate = _k10_rate(device)
        print(f"K10 many-stream copy rate: {rate} GB/s (published peak 3350 GB/s, power limit "
              f"{result['device']['power_limit_w']} W)", file=sys.stderr)
    names = list(marks)
    imports = ", ".join(f"{b} {marks[b] - marks[a]:.3f}" for a, b in zip(names, names[1:]))
    split = ", ".join(f"{k} {v:.3f}" for k, v in details["setup_split"].items())
    print(f"before the run (s): {imports}", file=sys.stderr)
    print(f"set-up split (s): {split}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
