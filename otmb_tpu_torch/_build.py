"""Build the CUDA kernels in `csrc/` into one shared library and load it.

The sources have a plain C interface (no PyTorch headers), so `nvcc`
compiles them in seconds: one `nvcc -c` per source, all started together,
then one link. The library is loaded with `ctypes`, and every pointer and
the stream are passed as `ctypes.c_void_p`. The build happens at the first
kernel launch of a process, never on import, and again whenever a source
or a flag changes: the library's file name carries a hash of both. The
build directory `_build/` is not committed.

No fast-math flag is ever passed: land is NaN by convention and the
kernels test it with `isnan`, and the one division of each kernel must
stay IEEE. `-fmad=false` keeps `a*b + c` as two roundings, so each
kernel rounds exactly where its plain PyTorch version does.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v",
    "-Xcompiler", "-fPIC",
)

#: Wall seconds the build took in this process (0.0 when the library was
#: already built), None before the first load.
build_seconds: float | None = None

_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}
# Calls of the launch path: each C entry point's through `launch` (a batch
# through an entry that also takes one field under "multi:" + the name),
# each graph's replays through `replay` (under the graph's name) and the
# entry calls a replay runs, and in `_total` the calls the host made.
_calls: dict[str, int] = {}
_total = 0
# Per host thread: the tally of the CUDA graph being captured (`capturing`).
_capture_tally = threading.local()
# The device the library's own CUDA runtime has current, per host thread:
# only this module changes it, so a launch selects a device only when it
# differs from the last one selected on the thread.
_selected = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libotmb_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/*.cu` into the library unless it exists: one compiler
    process per source, run in parallel, then the link. Raise with the
    compiler's output if any step fails."""
    global build_seconds
    path = library_path()
    if path.exists():
        build_seconds = 0.0
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = path.with_suffix("").name
    tag = f"{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{stem}-{src.stem}.{tag}.o" for src in sources]
    tmp = path.with_suffix(f".{tag}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name} ==\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objects)], capture_output=True, text=True)
        logs.append(f"== link ==\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr}")
    build_seconds = time.perf_counter() - t0
    path.with_suffix(".log").write_text("\n".join(logs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        _lib.otmb_cuda_error_string.argtypes = [ctypes.c_int]
        _lib.otmb_cuda_error_string.restype = ctypes.c_char_p
        _lib.otmb_set_device.argtypes = [ctypes.c_int]
        _lib.otmb_set_device.restype = ctypes.c_int
    return _lib


def _count(key: str) -> None:
    global _total
    tally = getattr(_capture_tally, "tally", None)
    if tally is not None:
        tally[key] = tally.get(key, 0) + 1
        key = "capture:" + key
    _calls[key] = _calls.get(key, 0) + 1
    _total += 1


def launch(name: str, argtypes: list, device: torch.device, *args, batch: bool = False) -> None:
    """Call the C entry point `name` on `device`, on PyTorch's current
    stream there (appended as the last argument); raise on a CUDA error.
    Each call that returns is one call of the launch path (`calls`). One
    made while a CUDA graph is captured (`capturing`) runs nothing: it is
    counted under "capture:" + `name`, which no kernel of `KERNELS` names,
    and in the graph's tally. `batch` marks a batch passed to an entry that
    also takes one field (K6, K7): it is counted under "multi:" + `name`,
    so the two count apart."""
    _select(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(function(name, argtypes)(*args, stream), name)
    _count("multi:" + name if batch else name)


def query(name: str, argtypes: list, device: torch.device, *args) -> None:
    """Call the C entry point `name`, which launches nothing (a launch's
    plan), with `device` current; raise on a CUDA error. Not a call of the
    launch path: `calls` does not count it."""
    _select(device)
    check(function(name, argtypes)(*args), name)


def _select(device: torch.device) -> None:
    lib = library()
    if getattr(_selected, "index", None) != device.index:
        check(lib.otmb_set_device(device.index), "cudaSetDevice")
        _selected.index = device.index


@contextlib.contextmanager
def capturing():
    """Count the entry calls made inside, on this thread, as a CUDA graph's
    that is being captured (`launch`), and yield their tally (entry name ->
    calls), for `replay`."""
    _capture_tally.tally = tally = {}
    try:
        yield tally
    finally:
        _capture_tally.tally = None


def replay(graph, tally: dict[str, int], name: str) -> None:
    """Replay a captured CUDA graph (`torch.cuda.CUDAGraph`) on the current
    stream: one call of the launch path, counted under `name` (the engine's
    BiCGStab(1) iteration is "graph:bicg1"), however many kernels the graph
    holds. The entry calls it runs, its `tally` from `capturing`, are
    counted under their own names, as if each were called again, so
    `KERNELS`' counts hold every run of a kernel's entries."""
    global _total
    graph.replay()
    _calls[name] = _calls.get(name, 0) + 1
    _total += 1
    for key, n in tally.items():
        _calls[key] = _calls.get(key, 0) + n


#: Each kernel's C entry calls as `calls` reads them: the prefixes of the
#: names it counts them under. K6 and K7 take one field or a batch through
#: the same entries; "K6 multi" and "K7 multi" are their batch calls.
KERNELS: dict[str, tuple[str, ...]] = {
    "K1": ("otmb_stencil_f", "otmb_stencil_bf"),
    "K2": ("otmb_thomas_",),
    "K3": ("otmb_krylov_",),
    "K4": ("otmb_assemble_f",),
    "K4 prep": ("otmb_assemble_prep_",),
    "K5": ("otmb_stencil_multi_",),
    "K6": ("otmb_redi_f", "otmb_redi_bf"),
    "K6 multi": ("multi:otmb_redi_f", "multi:otmb_redi_bf"),
    "K7": ("otmb_stencil_halo_",),
    "K7 multi": ("multi:otmb_stencil_halo_",),
    "K7 pack": ("otmb_halo_pack_",),
    "K7 edge": ("otmb_halo_edge_",),
    "K8": ("otmb_assemble_halo_",),
    "K9": ("otmb_redi_halo_",),
    "K10": ("otmb_probe_",),
    "K11": ("otmb_polish_sums_",),
    "K12": ("otmb_polish_update_",),
    "K13": ("otmb_bicg1_",),
}


def calls(prefix: str | tuple[str, ...] = "") -> int:
    """Calls of the launch path in this process counted under names that
    start with `prefix` (one prefix, or any of a tuple, such as a value of
    `KERNELS`); "" counts the calls the host made, each C entry call
    through `launch`, eager or captured, and each graph replay through
    `replay`. A call is not one kernel: an entry may launch two kernels (a
    sums kernel and its `alg_finish`), and a replay of the BiCGStab(1)
    iteration ("graph:bicg1") runs nine entry calls' twelve kernels. Under
    their own names the entry calls count as run, eagerly or in a replay;
    captured ones, which run nothing, count under "capture:" + the name."""
    if prefix == "":
        return _total
    return sum(n for name, n in _calls.items() if name.startswith(prefix))


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point `name` with its argument types declared; it
    returns a cudaError_t."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().otmb_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
