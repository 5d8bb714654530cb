"""K11 and K12: the vector algebra at the end of a BiCGStab(2) cycle.

The JAX package leaves this algebra to XLA, which fuses it inside the
jitted cycle (`otmb_tpu/models/solvers.py:_sr_chunk2_fused`); here it is
the CUDA kernels of `csrc/krylov_algebra.cu`:

  * K11 `polish_sums(r0, u1, r1, r2, alpha)` -> (r0 - alpha u1, sums), the
    sums (<r1, r1>, <r1, r2>, <r2, r2>, <r0', r1>, <r0', r2>) of the 2D
    minimal-residual polish along the last axis;
  * K12 `polish_update(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat)`
    -> (((y + alpha u0) + w1 r0) + w2 r1, (r0 - w1 r1) - w2 r2,
    (u0 - w1 u1) - w2 u2, <rhat, r0''>), the dot only when `rhat` is given
    (the next cycle's <rhat, r0>; None otherwise).

A field (nz, ny, nx) takes 0-d scalars and gives sums (5,) and a 0-d dot;
a batch (B, nz, ny, nx) takes (B,) scalars, one per member, and gives
sums (B, 5) and a (B,) dot, in one launch. The scalars stay on the
device. The sums accumulate in f64 in a fixed order and are rounded to the
fields' dtype (f32 or f64), so they are the same bits on every run. On a
process grid they are the shard's sums; the engine all-reduces them.

Each update is formed in float64 from the stored values and rounded to the
fields' dtype once (an f32 update chained in f32 rounds four to six times,
and lets the recurrence residual drift from the true one). A CUDA tensor
always goes to the kernel (errors raise); a CPU tensor takes the plain
version (`polish_sums_plain`, `polish_update_plain`): float64 products and
sums in the kernel's order, which the kernel, built with -fmad=false,
rounds alike, and f64 `torch.dot`s.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: Launches made by `polish_sums` (K11) and `polish_update` (K12).
SUMS_LAUNCHES = 0
UPDATE_LAUNCHES = 0

#: Cells a block takes at a time, and the most blocks a member gets
#: (kAlgTile, kAlgMaxBlocks in csrc/krylov_algebra.cu).
TILE, MAX_BLOCKS = 1024, 1024
NSUMS = 5

_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SUMS_ARGTYPES = [_P] * 8 + [_L, _I, _I, _P]
_UPDATE_ARGTYPES = [_P] * 16 + [_L, _I, _I, _I, _P]


def _blocks(n: int) -> int:
    return min(-(-n // TILE), MAX_BLOCKS)


def _member(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A member's scalar in float64, broadcast against its fields."""
    return (s.view(-1, 1, 1, 1) if x.ndim == 4 else s).double()


def dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> per member, accumulated in f64 and kept in f64: 0-d for a
    field, (B,) for a batch (one `torch.dot` each)."""
    if a.ndim == 4:
        return torch.stack([dot64(u, v) for u, v in zip(a, b)])
    return torch.dot(a.reshape(-1).double(), b.reshape(-1).double())


def _check(what: str, fields: dict, scalars: dict) -> torch.Tensor:
    """The first field, after checking that every field is a contiguous
    (nz, ny, nx) or (B, nz, ny, nx) tensor of its shape, dtype and device,
    and every scalar a tensor of the member shape () or (B,)."""
    x = next(iter(fields.values()))
    if x.ndim not in (3, 4):
        raise ValueError(f"{what}: fields must be (nz, ny, nx) or (B, nz, ny, nx), "
                         f"got {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty fields")
    for name, t in fields.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} is {type(t).__name__}, not a tensor")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"the first field {tuple(x.shape)} {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for name, s in scalars.items():
        if not isinstance(s, torch.Tensor) or s.shape != x.shape[:-3] or s.dtype != x.dtype \
                or s.device != x.device:
            raise ValueError(f"{what}: {name} must be a tensor of shape {tuple(x.shape[:-3])}, "
                             f"dtype {x.dtype}, on {x.device}")
    return x


def polish_sums_plain(r0, u1, r1, r2, alpha):
    """K11's plain version: r0 - alpha u1 (in f64, rounded once) and the five
    sums (f64 dots, rounded to the fields' dtype)."""
    r0 = (r0.double() - _member(alpha, r0) * u1.double()).to(r0.dtype)
    pairs = ((r1, r1), (r1, r2), (r2, r2), (r0, r1), (r0, r2))
    return r0, torch.stack([dot64(a, b) for a, b in pairs], dim=-1).to(r0.dtype)


def polish_update_plain(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat=None):
    """K12's plain version: the three updates in the kernel's order (in
    f64, each rounded once to the fields' dtype), and <rhat, r0''> (an f64
    dot rounded to the fields' dtype) when `rhat` is given."""
    a, c1, c2 = (_member(s, y) for s in (alpha, w1, w2))
    d = lambda t: t.double()
    dtype = y.dtype
    y_new = (((d(y) + a * d(u0)) + c1 * d(r0)) + c2 * d(r1)).to(dtype)
    r0 = ((d(r0) - c1 * d(r1)) - c2 * d(r2)).to(dtype)
    u0 = ((d(u0) - c1 * d(u1)) - c2 * d(u2)).to(dtype)
    return y_new, r0, u0, (None if rhat is None else dot64(rhat, r0).to(dtype))


def _geometry(x: torch.Tensor) -> tuple[int, int, int]:
    members = x.shape[0] if x.ndim == 4 else 1
    n = x.numel() // members
    return n, members, _blocks(n)


def polish_sums(r0: torch.Tensor, u1: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
                alpha: torch.Tensor):
    """K11: (r0 - alpha u1, the polish sums (..., 5)); see the module
    docstring."""
    global SUMS_LAUNCHES
    x = _check("polish_sums", dict(r0=r0, u1=u1, r1=r1, r2=r2), dict(alpha=alpha))
    if not x.is_cuda:
        return polish_sums_plain(r0, u1, r1, r2, alpha)
    if x.dtype not in _TYPES:
        raise TypeError(f"polish_sums: no kernel for {x.dtype}")
    n, members, nblk = _geometry(x)
    alpha = alpha.contiguous()  # held until the launch is enqueued
    r0_out = torch.empty_like(r0)
    sums = torch.empty(x.shape[:-3] + (NSUMS,), dtype=x.dtype, device=x.device)
    partials = torch.empty(members * nblk * NSUMS, dtype=torch.float64, device=x.device)
    _build.launch(f"otmb_polish_sums_{_TYPES[x.dtype]}", _SUMS_ARGTYPES, x.device,
                  r0.data_ptr(), u1.data_ptr(), r1.data_ptr(), r2.data_ptr(),
                  alpha.data_ptr(), r0_out.data_ptr(), partials.data_ptr(),
                  sums.data_ptr(), n, members, nblk)
    SUMS_LAUNCHES += 1
    return r0_out, sums


def polish_update(y: torch.Tensor, u0: torch.Tensor, r0: torch.Tensor, r1: torch.Tensor,
                  r2: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, alpha: torch.Tensor,
                  w1: torch.Tensor, w2: torch.Tensor, rhat: torch.Tensor | None = None):
    """K12: (y', r0'', u0', <rhat, r0''> or None); see the module
    docstring."""
    global UPDATE_LAUNCHES
    fields = dict(y=y, u0=u0, r0=r0, r1=r1, r2=r2, u1=u1, u2=u2)
    if rhat is not None:
        fields["rhat"] = rhat
    x = _check("polish_update", fields, dict(alpha=alpha, w1=w1, w2=w2))
    if not x.is_cuda:
        return polish_update_plain(y, u0, r0, r1, r2, u1, u2, alpha, w1, w2, rhat)
    if x.dtype not in _TYPES:
        raise TypeError(f"polish_update: no kernel for {x.dtype}")
    n, members, nblk = _geometry(x)
    alpha, w1, w2 = alpha.contiguous(), w1.contiguous(), w2.contiguous()
    y_out, r0_out, u0_out = torch.empty_like(y), torch.empty_like(r0), torch.empty_like(u0)
    dot = rhat is not None
    d = torch.empty(x.shape[:-3], dtype=x.dtype, device=x.device) if dot else None
    partials = (torch.empty(members * nblk, dtype=torch.float64, device=x.device)
                if dot else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch(f"otmb_polish_update_{_TYPES[x.dtype]}", _UPDATE_ARGTYPES, x.device,
                  y.data_ptr(), u0.data_ptr(), r0.data_ptr(), r1.data_ptr(), r2.data_ptr(),
                  u1.data_ptr(), u2.data_ptr(), ptr(rhat), alpha.data_ptr(), w1.data_ptr(),
                  w2.data_ptr(), y_out.data_ptr(),
                  r0_out.data_ptr(), u0_out.data_ptr(), ptr(partials), ptr(d), n, members,
                  nblk, int(dot))
    UPDATE_LAUNCHES += 1
    return y_out, r0_out, u0_out, d
