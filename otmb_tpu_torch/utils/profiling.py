"""K10: the many-stream bandwidth probe.

Counterpart of `otmb_tpu/utils/profiling.py:dma_peak_probe`, with the
CUDA kernel `csrc/probe.cu` in place of the Pallas one. A call reads
`nstreams` f32 streams and writes one, out = 0.999 * in[0] + in[1] + ...,
so its traffic is known exactly; bytes over time is the bandwidth a
many-stream kernel sustains on the card, the denominator for the other
kernels' bandwidth fractions. A CUDA tensor always goes to the kernel,
which equals the plain version bit for bit; a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .device import default_device

#: Kernel launches made by this module's wrapper.
LAUNCHES = 0

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
    global LAUNCHES
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
    LAUNCHES += 1
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
