"""K6: the Redi isoneutral-diffusion kernel, for one tracer and a batch,
the explicit T + R step in one walk, and the steady-state solves' T - R
matvec in one walk.

Replaces `otmb_tpu/models/redi_pallas.py` (`redi_apply_pallas`,
`redi_apply_pallas_multi`) with one CUDA kernel, `csrc/redi.cu`: a block
walks k down a tile of columns with four levels of chi in shared memory
and computes each derivative and face flux once. A batch is (B, nz, ny,
nx), batch-major as in the JAX package; the block reads the coefficients
once for a group of G members, G = 1, 2, 4 or 8 fixed when the kernel is
built (the batch rounded up to a power of two, at most 8 in f32 and 4 in
f64; `plan` reports it), so that each member's carried derivatives and
fluxes stay in registers. Where that holds a block to two an SM (f32 at
G = 8, f64 at G = 2) the step's coefficients come through shared memory a
step ahead, and the walk is split into level chunks so that the last wave
of tiles fills the card; the kernel is then bound by latency
(csrc/redi.cu's note has the numbers).
Member b of `redi_apply_fused_multi` equals `redi_apply_fused` on member
b, bit for bit, and both equal the plain version `models.redi.redi_apply`
on the card. `batch_groups` counts the batched launches by their group.

Coefficient and value types (C, V) are one of (f32, f32), (bf16, f32)
(`redi_operator_to_bf16`) and (f64, f64); the arithmetic runs in V. chi is
masked by the operator's wet mask inside the kernel.

A CUDA tensor always goes to the kernel, for every B >= 1, and a failure
raises. A CPU tensor takes the plain version.

`validate`, `step_entry` and `step` are what `ops.stencil`'s propagations
call with `redi=R`: the argument checks, the step entry of a (T's legs, R's
coefficients, values) type triple, and one T + R step, chi - dt T chi + dt
R chi, in one launch of K6's step mode (T's 7-point sum inside K6's walk,
the two-launch step's bits).

`apply_entry` and `matvec` are what `models.solvers` calls for a system
with `redi=R`: out = T chi - R chi (T with the system's shift folded into
its diagonal) in one launch of K6's matvec mode, the step mode's walk
writing acc - div: the plain composition `apply_stencil(T, chi) -
redi_apply(R, chi)`, bit for bit. It takes one tracer, in f32 throughout
(the inner solves) or f64 throughout (the refinement's defects).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..grid.topology import UNKNOWN, GridTopology
from .redi import _COEF_FIELDS, RediOperator, redi_apply

_ENTRY = {
    (torch.float32, torch.float32): "otmb_redi_f32_f32",
    (torch.bfloat16, torch.float32): "otmb_redi_bf16_f32",
    (torch.float64, torch.float64): "otmb_redi_f64_f64",
}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64"}
#: The step mode's entries by (T's legs, R's coefficients, values): every
#: triple that `ops.stencil` and `validate` take together.
_STEP_ENTRY = {(legs, coef, value): f"{entry}_step_{_SHORT[legs]}"
               for (coef, value), entry in _ENTRY.items()
               for legs in ((torch.float32, torch.bfloat16) if value == torch.float32
                            else (torch.float32, torch.float64))}
_STEP_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_void_p]
#: The matvec mode's entries by (T's legs, R's coefficients, values).
_APPLY_ENTRY = {(t,) * 3: f"{_ENTRY[(t, t)]}_apply_{_SHORT[t]}"
                for t in (torch.float32, torch.float64)}
_APPLY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: The matvec mode's entry names, as `_build.calls` counts their runs.
APPLY_ENTRIES = tuple(_APPLY_ENTRY.values())
_PLANES = ("inv_de", "inv_dn")

#: Batched launches on the card (`redi_apply_fused_multi` and the batched
#: T + R step) by the member group G the launch took.
batch_groups: dict[int, int] = {}
_plans: dict[tuple, dict[str, int]] = {}


def validate(op: RediOperator, chi: torch.Tensor, batched: bool,
             topology: GridTopology | None = None) -> None:
    """Raise unless K6 takes `op` and `chi` (one tracer, or a batch with
    `batched`): a RediOperator whose fields match chi's shape and device, in
    a (coefficients, values) type pair K6 has, contiguous; and, given
    `topology` (a stencil's), on that grid."""
    if not isinstance(op, RediOperator):
        raise TypeError(f"redi: got a {type(op).__name__}, expected a RediOperator "
                        f"(build_redi_operator)")
    topo = op.topology
    if topology is not None and (topo.kind != topology.kind or topo.shape3d != topology.shape3d):
        raise ValueError(f"redi: the operator is on a {topo.kind} grid of {topo.shape3d}, the "
                         f"stencil on a {topology.kind} grid of {topology.shape3d}")
    if topo.kind == UNKNOWN:
        raise ValueError("redi: unknown grid topology")
    key = (op.ae.dtype, chi.dtype)
    if key not in _ENTRY:
        raise TypeError(f"redi: no kernel for (coefficients, values) = {key}; "
                        f"supported: {sorted(map(str, _ENTRY))}")
    shape = topo.shape3d
    dims = ", ".join(map(str, shape))
    if batched and not (chi.ndim == 4 and chi.shape[0] >= 1 and tuple(chi.shape[1:]) == shape):
        raise ValueError(f"redi: chis has shape {tuple(chi.shape)}, expected (B, {dims}) "
                         f"with B >= 1")
    if not batched and tuple(chi.shape) != shape:
        raise ValueError(f"redi: chi has shape {tuple(chi.shape)}, expected ({dims})")
    fields = [(name, getattr(op, name), topo.shape2d if name in _PLANES else shape, op.ae.dtype)
              for name in _COEF_FIELDS]
    fields += [("wet", op.wet, shape, torch.bool), ("chi", chi, tuple(chi.shape), chi.dtype)]
    for name, t, expect_shape, expect_dtype in fields:
        if tuple(t.shape) != expect_shape:
            raise ValueError(f"redi: {name} has shape {tuple(t.shape)}, expected {expect_shape}")
        if t.dtype != expect_dtype:
            raise TypeError(f"redi: {name} is {t.dtype}, expected {expect_dtype}")
        if t.device != chi.device:
            raise ValueError(f"redi: {name} is on {t.device}, chi on {chi.device}")
        if not t.is_contiguous():
            raise ValueError(f"redi: {name} is not contiguous")


def _args(op: RediOperator, chi: torch.Tensor, out: torch.Tensor, batched: bool) -> tuple:
    """The entry's arguments before its scalars: the coefficient table, the
    wet mask, chi, out, the members and the sizes."""
    nz, ny, nx = op.topology.shape3d
    fields = (ctypes.c_void_p * len(_COEF_FIELDS))(
        *(getattr(op, name).data_ptr() for name in _COEF_FIELDS))
    return (ctypes.cast(fields, ctypes.c_void_p), op.wet.data_ptr(), chi.data_ptr(),
            out.data_ptr(), chi.shape[0] if batched else 1, nz, ny, nx,
            int(op.topology.is_tripolar))


def step_entry(legs: torch.dtype, coef: torch.dtype, value: torch.dtype) -> str:
    """The step mode's entry for T's legs, R's coefficients and the values
    in these types; raise TypeError where it has none."""
    key = (legs, coef, value)
    if key not in _STEP_ENTRY:
        raise TypeError(f"redi: no T + R step for (T's legs, R's coefficients, values) = {key}; "
                        f"supported: {sorted(map(str, _STEP_ENTRY))}")
    return _STEP_ENTRY[key]


def apply_entry(legs: torch.dtype, coef: torch.dtype, value: torch.dtype) -> str:
    """The matvec mode's entry for T's legs, R's coefficients and the values
    in these types; raise TypeError where it has none."""
    key = (legs, coef, value)
    if key not in _APPLY_ENTRY:
        raise TypeError(f"redi: no T - R matvec for (T's legs, R's coefficients, values) = "
                        f"{key}; supported: {sorted(map(str, _APPLY_ENTRY))}")
    return _APPLY_ENTRY[key]


def plan(op: RediOperator, chi: torch.Tensor, batched: bool, mode: str = "plain",
         legs: torch.dtype | None = None) -> dict[str, int]:
    """How K6 launches on `chi`'s card for this operator and batch: `mode`
    "plain" (out = R chi), "step" (the step mode, T's legs in `legs`) or
    "apply" (the matvec mode, one tracer, T's legs in `legs` or chi's
    dtype). It gives the member group G its kernel was built for
    ("group"), the blocks an SM holds ("per_sm") and the chunks of levels
    each tile's walk is split into ("chunks"): the kernel's own rule, asked
    once per shape."""
    if mode not in ("plain", "step", "apply"):
        raise ValueError(f"redi: unknown K6 mode {mode!r}")
    if mode == "apply" and legs is None:
        legs = chi.dtype
    nz, ny, nx = op.topology.shape3d
    b = chi.shape[0] if batched else 1
    key = (op.ae.dtype, chi.dtype, b, nz, ny, nx, legs, mode, chi.device.index)
    if key not in _plans:
        entry = (_ENTRY[(op.ae.dtype, chi.dtype)] if mode == "plain"
                 else step_entry(legs, op.ae.dtype, chi.dtype) if mode == "step"
                 else apply_entry(legs, op.ae.dtype, chi.dtype))
        got = (ctypes.c_int * 3)()
        _build.query("otmb_redi_plan_" + entry[len("otmb_redi_"):], _PLAN_ARGTYPES, chi.device,
                     b, nz, ny, nx, ctypes.addressof(got))
        _plans[key] = dict(zip(("group", "per_sm", "chunks"), got))
    return _plans[key]


def _tally(op: RediOperator, chi: torch.Tensor, batched: bool, mode: str = "plain",
           legs: torch.dtype | None = None) -> None:
    if batched:
        g = plan(op, chi, batched, mode, legs)["group"]
        batch_groups[g] = batch_groups.get(g, 0) + 1


def _run(op: RediOperator, chi: torch.Tensor, batched: bool) -> torch.Tensor:
    validate(op, chi, batched)
    if not chi.is_cuda:
        return redi_apply(op, chi)
    out = torch.empty_like(chi)
    _build.launch(_ENTRY[(op.ae.dtype, chi.dtype)], _ARGTYPES, chi.device,
                  *_args(op, chi, out, batched), batch=batched)
    _tally(op, chi, batched)
    return out


def step(legs, op: RediOperator, chi: torch.Tensor, out: torch.Tensor, dt: float,
         batched: bool) -> None:
    """out = chi - dt T chi + dt R chi on the card in one launch of K6's
    step mode, T given by its seven legs in K5's order (diag, east, west,
    north, south, top, bottom; a `StencilCoeffs`): K5's (K1's) rounding of
    chi - dt T chi, then + dt R chi rounded, as the two launches gave it.
    Counted under K6 or, for a batch, K6 multi. The arguments are the
    caller's to check (`ops.stencil._validate`, `validate`, `step_entry`);
    `out` is a CUDA tensor like chi that is not chi."""
    legs = tuple(legs)
    table = (ctypes.c_void_p * 7)(*(leg.data_ptr() for leg in legs))
    fields, wet, x, y, *sizes = _args(op, chi, out, batched)
    _build.launch(step_entry(legs[0].dtype, op.ae.dtype, chi.dtype), _STEP_ARGTYPES,
                  chi.device, fields, wet, ctypes.cast(table, ctypes.c_void_p), x, y, *sizes,
                  float(dt), batch=batched)
    _tally(op, chi, batched, "step", legs[0].dtype)


def matvec(legs, op: RediOperator, chi: torch.Tensor) -> torch.Tensor:
    """T chi - R chi for one tracer on the card in one launch of K6's matvec
    mode, T given by its seven legs in K5's order (a `StencilCoeffs`, any
    shift folded into its diagonal): K1's rounding of T chi, then R chi
    taken off and rounded once, as the plain composition gives it. Counted
    under K6. The arguments are the caller's to check (`validate`,
    `apply_entry`); chi is a CUDA tensor."""
    legs = tuple(legs)
    table = (ctypes.c_void_p * 7)(*(leg.data_ptr() for leg in legs))
    out = torch.empty_like(chi)
    fields, wet, x, y, _, *sizes = _args(op, chi, out, False)
    _build.launch(apply_entry(legs[0].dtype, op.ae.dtype, chi.dtype), _APPLY_ARGTYPES,
                  chi.device, fields, wet, ctypes.cast(table, ctypes.c_void_p), x, y, *sizes)
    return out


def redi_apply_fused(op: RediOperator, chi: torch.Tensor) -> torch.Tensor:
    """d(chi)/dt of Redi isoneutral diffusion for one tracer (nz, ny, nx)
    in one K6 launch (the kernel of `redi_apply_pallas`)."""
    return _run(op, chi, batched=False)


def redi_apply_fused_multi(op: RediOperator, chis: torch.Tensor) -> torch.Tensor:
    """d(chis[b])/dt for a batch (B, nz, ny, nx) in one K6 launch that reads
    the coefficients once (the kernel of `redi_apply_pallas_multi`)."""
    return _run(op, chis, batched=True)
