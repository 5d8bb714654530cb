"""Profiling: the K10 bandwidth probe, step timing, roofline reports,
traffic models and profiler traces.

Counterpart of `otmb_tpu/utils/profiling.py`:

  * K10 `dma_peak_probe`, with the CUDA kernel `csrc/probe.cu` in place of
    the Pallas one. A call reads `nstreams` f32 streams and writes one,
    out = 0.999 * in[0] + in[1] + ..., so its traffic is known exactly;
    bytes over time is the bandwidth a many-stream kernel sustains on the
    card, the denominator for the other kernels' bandwidth fractions. A
    CUDA tensor always goes to the kernel, which equals the plain version
    bit for bit; a CPU tensor takes the plain version.
  * `chained_step_time`: per-step time of an iterated step, between CUDA
    events on the card (the host clock on the CPU);
  * `roofline_report`: the achieved rate of a step with a known byte count
    against a bandwidth measured by K10 on the same card (or one given);
  * `stencil_bytes` and `halo_comm_model`: traffic counts and a model of
    the halo exchange's share, with the link and memory rates as
    arguments (no TPU peaks);
  * `trace`, `trace_kernel_times`, `kernel_time_us`: `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time

import torch

from .. import _build
from .device import default_device

MAX_STREAMS = 16  # kProbeMaxStreams in csrc/probe.cu
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def probe_sum_plain(streams) -> torch.Tensor:
    """0.999 * streams[0] + streams[1] + ..., added in that order."""
    acc = streams[0] * 0.999
    for s in streams[1:]:
        acc = acc + s
    return acc


def probe_sum(streams) -> torch.Tensor:
    """The probe on f32 tensors of one shape and device, contiguous, at
    most MAX_STREAMS of them, their size a multiple of 4 elements."""
    streams = list(streams)
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"probe_sum: {len(streams)} streams, expected 1..{MAX_STREAMS}")
    first = streams[0]
    for t in streams:
        if t.dtype != torch.float32:
            raise TypeError(f"probe_sum: streams must be float32, got {t.dtype}")
        if t.shape != first.shape or t.device != first.device or not t.is_contiguous():
            raise ValueError("probe_sum: streams must be contiguous, of one shape and device")
    if not first.is_cuda:
        return probe_sum_plain(streams)
    if first.numel() % 4 or any(t.data_ptr() % 16 for t in streams):
        raise ValueError("probe_sum: the kernel reads float4: size must be a multiple of 4 "
                         "and every stream 16-byte aligned")
    out = torch.empty_like(first)
    ptrs = (ctypes.c_void_p * len(streams))(*(t.data_ptr() for t in streams))
    _build.launch("otmb_probe_f32", _ARGTYPES, first.device,
                  ctypes.cast(ptrs, ctypes.c_void_p), len(streams), out.data_ptr(),
                  first.numel())
    return out


def dma_peak_probe(nstreams: int = 7, mbytes: int = 200, device=None):
    """A known-traffic probe of the device's many-stream bandwidth.

    Makes `nstreams` f32 streams of `mbytes` MiB each (1 MiB planes of
    512 x 512, normal random numbers from a generator seeded 0) on `device`
    and returns (thunk, bytes_moved): each run of the thunk is one probe
    call whose traffic is exactly `bytes_moved` (nstreams reads + 1 write).
    Use at least 7 x 200 MiB on the card, so its 50 MB L2 cannot serve it.
    `device=None` is the current CUDA device, and raises without one."""
    device = default_device(device)
    ny, nx = 512, 512
    nzb = max(1, mbytes * 1024 * 1024 // (ny * nx * 4))
    gen = torch.Generator(device=device).manual_seed(0)
    streams = [torch.randn((nzb, ny, nx), generator=gen, dtype=torch.float32, device=device)
               for _ in range(nstreams)]
    bytes_moved = (nstreams + 1) * nzb * ny * nx * 4
    return (lambda: probe_sum(streams)), bytes_moved


def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def chained_step_time(step_fn, x0: torch.Tensor, nsteps: int = 100, repeats: int = 3) -> float:
    """Best per-step seconds of `x -> step_fn(x)` iterated `nsteps` times,
    each step fed the previous output, over `repeats` runs after one
    warm-up step. On a CUDA tensor the runs are timed between CUDA events
    (the wrapper's host work overlaps the device's, as in a loop); on a CPU
    tensor by the host clock, and the time is then the CPU's."""
    x = step_fn(x0)
    _sync(x)
    best = float("inf")
    for _ in range(repeats):
        x = x0
        if x0.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(nsteps):
                x = step_fn(x)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(nsteps):
                x = step_fn(x)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / nsteps)
    return best


def probe_gbps(device, nsteps: int = 20) -> float:
    """The many-stream bandwidth (GB/s) K10 sustains on a CUDA `device`:
    7 streams of 200 MiB, so the 50 MB L2 cannot serve them."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("probe_gbps measures a CUDA device's bandwidth")
    run, nbytes = dma_peak_probe(device=device)
    return nbytes / chained_step_time(lambda _: run(), torch.empty(0, device=device),
                                      nsteps=nsteps) / 1e9


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    seconds_per_step: float
    steps_per_second: float
    bytes_per_step: int
    achieved_gbps: float
    peak_gbps: float | None
    fraction_of_peak: float | None
    device: str

    def __str__(self) -> str:
        frac = (f" ({100 * self.fraction_of_peak:.0f}% of {self.peak_gbps:.0f} GB/s)"
                if self.fraction_of_peak is not None else "")
        return (f"{self.seconds_per_step * 1e6:.0f} us/step, "
                f"{self.steps_per_second:.0f} steps/s, "
                f"{self.achieved_gbps:.0f} GB/s{frac} on {self.device}")


def roofline_report(step_fn, x0: torch.Tensor, bytes_per_step: int, nsteps: int = 100,
                    peak_gbps: float | None = None) -> RooflineReport:
    """Time `step_fn` (`chained_step_time`) and relate the rate on its
    `bytes_per_step` to `peak_gbps`. Left out, on a CUDA tensor, the peak
    is K10's rate measured now on the same card (`probe_gbps`; the JAX
    package took a TPU generation's HBM peak); on the CPU there is no
    probe rate, and the fraction is None. The report names the device it
    was timed on."""
    t = chained_step_time(step_fn, x0, nsteps=nsteps)
    gbps = bytes_per_step / t / 1e9
    if peak_gbps is None and x0.is_cuda:
        peak_gbps = probe_gbps(x0.device)
    name = torch.cuda.get_device_name(x0.device) if x0.is_cuda else "cpu"
    return RooflineReport(
        seconds_per_step=t,
        steps_per_second=1.0 / t,
        bytes_per_step=bytes_per_step,
        achieved_gbps=gbps,
        peak_gbps=peak_gbps,
        fraction_of_peak=(gbps / peak_gbps) if peak_gbps else None,
        device=name,
    )


def stencil_bytes(shape3d, dtype_bytes: int = 4, streams: int = 9) -> int:
    """Compulsory traffic of one stencil apply: 7 coefficient reads, 1
    tracer read and 1 write."""
    nz, ny, nx = shape3d
    return streams * nz * ny * nx * dtype_bytes


def halo_comm_model(topology, mesh_shape: tuple[int, int], link_gbps: float,
                    mem_gbps: float, dtype_bytes: int = 4) -> dict:
    """Analytical comm/compute model of the halo-exchanged stencil step on
    a (ny_dev, nx_dev) process grid. Per step each shard moves 2 * (nx_l +
    ny_l) * nz halo cells over the link at `link_gbps` while streaming 9
    local slabs from device memory at `mem_gbps`; both rates are the
    caller's (measured, or a data sheet's: an H100's NVLink moves 450 GB/s
    each way, and K10 measures its memory)."""
    nz, ny, nx = topology.shape3d
    ny_dev, nx_dev = mesh_shape
    ny_l, nx_l = ny // ny_dev, nx // nx_dev
    halo_bytes = 2 * (nx_l + ny_l) * nz * dtype_bytes
    interior_bytes = 9 * nz * ny_l * nx_l * dtype_bytes
    t_comm = halo_bytes / (link_gbps * 1e9)
    t_comp = interior_bytes / (mem_gbps * 1e9)
    return {
        "halo_bytes_per_step": halo_bytes,
        "interior_bytes_per_step": interior_bytes,
        "t_comm_s": t_comm,
        "t_compute_s": t_comp,
        "scaling_efficiency_overlapped": t_comp / max(t_comp, t_comm),
        "scaling_efficiency_serial": t_comp / (t_comp + t_comm),
    }


def _activities():
    from torch.profiler import ProfilerActivity

    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])


@contextlib.contextmanager
def trace(logdir: str):
    """A `torch.profiler` trace of the block, written to
    `<logdir>/trace.json` (Chrome trace format: chrome://tracing or
    Perfetto)."""
    import os

    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def trace_kernel_times(thunks, logdir: str | None = None) -> dict:
    """Device durations from a `torch.profiler` trace: runs each thunk
    (synchronising after it) under the profiler and returns
    ``{name: (count, avg_us)}`` for every kernel on a CUDA device, the
    ctypes-launched kernels included. Without a CUDA device the names are
    the CPU's operators and the times the CPU's. With `logdir`, the trace
    is also written there."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    on_cuda = torch.cuda.is_available()
    with profile(activities=_activities()) as prof:
        for thunk in thunks:
            out = thunk()
            if on_cuda:
                torch.cuda.synchronize()
            del out
    if logdir is not None:
        import os

        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    want = DeviceType.CUDA if on_cuda else DeviceType.CPU
    agg: dict = {}
    for e in prof.events():
        if e.device_type == want:
            n, tot = agg.get(e.name, (0, 0.0))
            agg[e.name] = (n + 1, tot + e.time_range.elapsed_us())
    return {name: (n, tot / n) for name, (n, tot) in agg.items()}


def kernel_time_us(times: dict, match: str) -> float | None:
    """Average duration (us) of the kernels whose name contains `match`, in
    a `trace_kernel_times` result, weighted by count; None if absent."""
    hits = [(n, avg) for name, (n, avg) in times.items() if match in name]
    if not hits:
        return None
    tot_n = sum(n for n, _ in hits)
    return sum(n * avg for n, avg in hits) / tot_n
