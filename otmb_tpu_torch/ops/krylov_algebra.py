"""K11 and K12: the vector algebra at the end of a BiCGStab(2) cycle; K13:
the vector algebra of a BiCGStab(1) iteration.

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

K13 (`csrc/krylov_algebra.cu`) is one BiCGStab(1) iteration's algebra
around its K2 and K1 launches, the reference's `_sr_chunk1` body in four
entries, with a global reduction between each two:

  * `bicg1_sums(a, b, with_aa=False)` -> (..., 1) <a, b>, or (..., 2)
    (<a, b>, <a, a>) with `with_aa` (a read once): <v, rhat> after
    v = A phat, (<t, s>, <t, t>) after t = A shat;
  * `bicg1_s(r, v, rho, dv)` -> (s, alpha): alpha = rho / guard(dv) and
    s = r - alpha v;
  * `bicg1_update(x, phat, shat, s, t, rhat, alpha, ts)` -> (x', r', omega,
    <rhat, r'>): omega = ts[0] / guard(ts[1]), x' = (x + alpha phat) +
    omega shat, r' = s - omega t;
  * `bicg1_p(r, p, v, rho, rho_new, alpha, omega)` -> p' = r + beta (p -
    omega v), beta = (rho_new / guard(rho)) (alpha / guard(omega));

guard(d) = d where d != 0, else 1. The scalars are formed in the fields'
dtype from the reduced sums, on the device; sums, updates, batches and
rounding are K11's and K12's. On a process grid the sums are the shard's,
and the engine all-reduces them (three all-reduces an iteration). The
plain versions are `bicg1_*_plain`. Every output is a fresh tensor,
except where `bicg1_update` and `bicg1_p` are given tensors to write x',
r', <rhat, r'> and p' into (`x_out`, `r_out`, `rho_out`, `out`): the
engine's graphed BiCGStab(1) loop writes each iteration into the state set
the previous one read (`models/solvers.py:_PingPong`). An output tensor
must not be an input of the same call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: Cells a block takes at a time, and the most blocks a member gets
#: (kAlgTile, kAlgMaxBlocks in csrc/krylov_algebra.cu); a block's threads,
#: the cells a thread takes from a tile, and the finish kernel's threads
#: (kAlgThreads, kAlgPer, kAlgFinishThreads).
TILE, MAX_BLOCKS = 1024, 1024
THREADS, PER, FINISH_THREADS = 256, 4, 256
NSUMS = 5

_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SUMS_ARGTYPES = [_P] * 8 + [_L, _I, _I, _P]
_UPDATE_ARGTYPES = [_P] * 16 + [_L, _I, _I, _I, _P]
_BICG1_ARGTYPES = {"sums": [_P] * 4 + [_L, _I, _I, _I, _P], "s": [_P] * 6 + [_L, _I, _I, _P],
                   "update": [_P] * 13 + [_L, _I, _I, _P], "p": [_P] * 8 + [_L, _I, _I, _P]}


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
    return r0_out, sums


def polish_update(y: torch.Tensor, u0: torch.Tensor, r0: torch.Tensor, r1: torch.Tensor,
                  r2: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, alpha: torch.Tensor,
                  w1: torch.Tensor, w2: torch.Tensor, rhat: torch.Tensor | None = None):
    """K12: (y', r0'', u0', <rhat, r0''> or None); see the module
    docstring."""
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
    return y_out, r0_out, u0_out, d


def _guard(d: torch.Tensor) -> torch.Tensor:
    """d where d != 0, else 1 (the reference's breakdown guard)."""
    return torch.where(d == 0, torch.ones_like(d), d)


def _check_sums(what: str, name: str, sums: torch.Tensor, x: torch.Tensor, width: int) -> None:
    if not isinstance(sums, torch.Tensor) or sums.shape != x.shape[:-3] + (width,) \
            or sums.dtype != x.dtype or sums.device != x.device:
        raise ValueError(f"{what}: {name} must be a tensor of shape "
                         f"{tuple(x.shape[:-3]) + (width,)}, dtype {x.dtype}, on {x.device}")


def _warp_tree(v: torch.Tensor) -> torch.Tensor:
    """A warp's shuffle tree over the last axis (32 lanes): lane i adds lane
    i + off for off = 16, 8, 4, 2, 1, and lane 0 holds the sum."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _block_tree(v: torch.Tensor) -> torch.Tensor:
    """`block_sums` over the last axis (a block's threads): each warp's tree,
    then warp 0's tree over the warp sums, its other lanes 0."""
    warps = _warp_tree(v.unflatten(-1, (-1, 32)))
    return _warp_tree(torch.nn.functional.pad(warps, (0, 32 - warps.shape[-1])))


def tree_sum(prod: torch.Tensor) -> torch.Tensor:
    """The sums over the last axis of float64 products (members, n), each
    member in the order of K13's kernels: thread t of block b adds the cells
    t + 256 q of tiles b, b + nblk, ... (tile by tile, q = 0..3) to 0.0 in
    turn, the block sums its threads by `_block_tree`, and the finish
    kernel's thread t adds the blocks t, t + 256, ... in turn before its
    own `_block_tree`. Padding adds +0.0 to sums that start at +0.0, which
    changes no bit. Returns (members,) float64."""
    members, n = prod.shape
    nblk = _blocks(n)
    tiles = -(-n // TILE)
    rounds = -(-tiles // nblk)
    cells = torch.nn.functional.pad(prod, (0, rounds * nblk * TILE - n))
    cells = cells.view(members, rounds, nblk, PER, THREADS).permute(0, 2, 4, 1, 3)
    acc = torch.zeros((members, nblk, THREADS), dtype=torch.float64, device=prod.device)
    for k in range(rounds * PER):
        acc = acc + cells[..., k // PER, k % PER]
    partials = _block_tree(acc)
    turns = -(-nblk // FINISH_THREADS)
    partials = torch.nn.functional.pad(partials, (0, turns * FINISH_THREADS - nblk))
    partials = partials.view(members, turns, FINISH_THREADS)
    acc = torch.zeros((members, FINISH_THREADS), dtype=torch.float64, device=prod.device)
    for k in range(turns):
        acc = acc + partials[:, k]
    return _block_tree(acc)


def _sum64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> per member in K13's order (`tree_sum`), rounded to a's dtype:
    0-d for a field, (B,) for a batch."""
    prod = (a.double() * b.double()).reshape(-1, a.shape[-3:].numel())
    return tree_sum(prod).reshape(a.shape[:-3]).to(a.dtype)


def bicg1_sums_plain(a, b, with_aa: bool = False):
    """K13's sums, plain: f64 products summed in the kernel's order and
    rounded to the fields' dtype."""
    pairs = ((a, b), (a, a)) if with_aa else ((a, b),)
    return torch.stack([_sum64(u, w) for u, w in pairs], dim=-1)


def bicg1_s_plain(r, v, rho, dv):
    """K13's s entry, plain: alpha in the fields' dtype, s formed in f64 and
    rounded once."""
    alpha = rho / _guard(dv[..., 0])
    return (r.double() - _member(alpha, r) * v.double()).to(r.dtype), alpha


def bicg1_update_plain(x, phat, shat, s, t, rhat, alpha, ts):
    """K13's update entry, plain: omega in the fields' dtype, x' and r'
    formed in f64 and rounded once, and <rhat, r'> (f64 products summed in
    the kernel's order, rounded to the fields' dtype)."""
    omega = ts[..., 0] / _guard(ts[..., 1])
    a, w = _member(alpha, x), _member(omega, x)
    x_new = ((x.double() + a * phat.double()) + w * shat.double()).to(x.dtype)
    r_new = (s.double() - w * t.double()).to(x.dtype)
    return x_new, r_new, omega, _sum64(rhat, r_new)


def bicg1_p_plain(r, p, v, rho, rho_new, alpha, omega):
    """K13's p entry, plain: beta in the fields' dtype, p' formed in f64 and
    rounded once."""
    beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
    b, w = _member(beta, r), _member(omega, r)
    return (r.double() + b * (p.double() - w * v.double())).to(r.dtype)


def _check13(what: str, fields: dict, scalars: dict) -> torch.Tensor:
    """`_check`, and the fields' dtype one K13 takes (f32 or f64) on every
    device."""
    x = _check(what, fields, scalars)
    if x.dtype not in _TYPES:
        raise TypeError(f"{what}: fields must be float32 or float64, got {x.dtype}")
    return x


def _bicg1_launch(entry: str, x: torch.Tensor, *tensors, flag: int | None = None) -> None:
    """Launch K13's `entry` on the fields of `x`'s shape, with the tensors'
    pointers in the C entry's order (and `flag`, the sums' with_aa)."""
    n, members, nblk = _geometry(x)
    _build.launch(f"otmb_bicg1_{entry}_{_TYPES[x.dtype]}", _BICG1_ARGTYPES[entry], x.device,
                  *(t.data_ptr() for t in tensors), n, members, nblk,
                  *(() if flag is None else (flag,)))


def _partials(x: torch.Tensor, width: int) -> torch.Tensor:
    """The blocks' f64 partial sums of a launch on the fields of `x`."""
    n, members, nblk = _geometry(x)
    return torch.empty(members * nblk * width, dtype=torch.float64, device=x.device)


def bicg1_sums(a: torch.Tensor, b: torch.Tensor, with_aa: bool = False) -> torch.Tensor:
    """K13: (..., 1) <a, b>, or (..., 2) (<a, b>, <a, a>) with `with_aa`;
    see the module docstring."""
    x = _check13("bicg1_sums", dict(a=a, b=b), {})
    if not x.is_cuda:
        return bicg1_sums_plain(a, b, with_aa)
    width = 2 if with_aa else 1
    sums = torch.empty(x.shape[:-3] + (width,), dtype=x.dtype, device=x.device)
    _bicg1_launch("sums", x, a, b, _partials(x, width), sums, flag=int(with_aa))
    return sums


def bicg1_s(r: torch.Tensor, v: torch.Tensor, rho: torch.Tensor, dv: torch.Tensor):
    """K13: (s, alpha); see the module docstring."""
    x = _check13("bicg1_s", dict(r=r, v=v), dict(rho=rho))
    _check_sums("bicg1_s", "dv", dv, x, 1)
    if not x.is_cuda:
        return bicg1_s_plain(r, v, rho, dv)
    rho, dv = rho.contiguous(), dv.contiguous()  # held until the launch is enqueued
    s, alpha = torch.empty_like(r), torch.empty_like(rho)
    _bicg1_launch("s", x, r, v, rho, dv, s, alpha)
    return s, alpha


def _outputs(what: str, fields: dict, scalars: dict, like: torch.Tensor) -> None:
    """Check the given output tensors (None: a fresh one) as `_check` checks
    the inputs, against the fields of `like`."""
    given = lambda d: {name: t for name, t in d.items() if t is not None}
    if given(fields) or given(scalars):
        _check(what, dict(like=like, **given(fields)), given(scalars))


def _into(out: torch.Tensor | None, value: torch.Tensor) -> torch.Tensor:
    """`value`, copied into `out` where one is given."""
    return value if out is None else out.copy_(value)


def bicg1_update(x: torch.Tensor, phat: torch.Tensor, shat: torch.Tensor, s: torch.Tensor,
                 t: torch.Tensor, rhat: torch.Tensor, alpha: torch.Tensor, ts: torch.Tensor,
                 x_out: torch.Tensor | None = None, r_out: torch.Tensor | None = None,
                 rho_out: torch.Tensor | None = None):
    """K13: (x', r', omega, <rhat, r'>), x', r' and <rhat, r'> written into
    `x_out`, `r_out` and `rho_out` where given; see the module docstring."""
    f = _check13("bicg1_update", dict(x=x, phat=phat, shat=shat, s=s, t=t, rhat=rhat),
               dict(alpha=alpha))
    _check_sums("bicg1_update", "ts", ts, f, 2)
    _outputs("bicg1_update", dict(x_out=x_out, r_out=r_out), dict(rho_out=rho_out), f)
    if not f.is_cuda:
        x_new, r_new, omega, rho = bicg1_update_plain(x, phat, shat, s, t, rhat, alpha, ts)
        return _into(x_out, x_new), _into(r_out, r_new), omega, _into(rho_out, rho)
    alpha, ts = alpha.contiguous(), ts.contiguous()
    x_new = torch.empty_like(x) if x_out is None else x_out
    r_new = torch.empty_like(s) if r_out is None else r_out
    rho = torch.empty_like(alpha) if rho_out is None else rho_out
    omega = torch.empty_like(alpha)
    _bicg1_launch("update", f, x, phat, shat, s, t, rhat, alpha, ts, x_new, r_new, omega,
                  _partials(f, 1), rho)
    return x_new, r_new, omega, rho


def bicg1_p(r: torch.Tensor, p: torch.Tensor, v: torch.Tensor, rho: torch.Tensor,
            rho_new: torch.Tensor, alpha: torch.Tensor, omega: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """K13: p' = r + beta (p - omega v), written into `out` where given; see
    the module docstring."""
    x = _check13("bicg1_p", dict(r=r, p=p, v=v),
               dict(rho=rho, rho_new=rho_new, alpha=alpha, omega=omega))
    _outputs("bicg1_p", dict(out=out), {}, x)
    if not x.is_cuda:
        return _into(out, bicg1_p_plain(r, p, v, rho, rho_new, alpha, omega))
    scalars = [t.contiguous() for t in (rho, rho_new, alpha, omega)]
    p_new = torch.empty_like(p) if out is None else out
    _bicg1_launch("p", x, r, p, v, *scalars, p_new)
    return p_new
