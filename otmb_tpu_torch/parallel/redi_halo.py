"""K9: the Redi operator R chi on one shard of a process grid.

Replaces `otmb_tpu/parallel/redi_halo.py` (`redi_apply_halo_pallas`). K6
derives every derivative and face flux from reads in a one-cell ring
(k +- 1, no diagonal neighbours) around its tiles. So a shard
needs at its four edges the ring of wet flags and of chi at every level,
and the neighbours' coefficients that K6 reads there: cz_u and cz_d on all
four sides; ae, s_e and inv_de of the west neighbours; an, s_n and inv_dn
of the south neighbours; across the tripolar fold the mirror shard's
reversed top row (the seam's cross term is off through s_n = 0, as in K6).

The coefficient and wet lines are static per operator: `redi_shard`
exchanges them once, and each `redi_apply_halo` exchanges only chi's lines
(`parallel/halo._halo_exchange`), one round per apply as in the JAX
package. K9 (`csrc/redi.cu`, the kShard instantiation of K6) reads those
lines where K6 reads the neighbours, so on each shard it equals K6 on the
whole field bit for bit. One tracer: the JAX package has no batched
sharded Redi.

A CUDA tensor goes to K9, and a failure raises; a CPU tensor takes the
plain version, `_redi_plain`: `models.redi.redi_apply` on the shard with
a one-cell ring from the lines, which on each shard equals `redi_apply` on
the whole field.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build
from ..grid.topology import BIPOLAR, UNKNOWN, GridTopology
from ..models.redi import _COEF_FIELDS, RediOperator, redi_apply
from ..models.redi_kernel import _ENTRY as _K6_ENTRY
from .halo import _exchange, _halo_exchange
from .mesh import ProcessGrid

_ENTRY = {key: name.replace("otmb_redi_", "otmb_redi_halo_") for key, name in _K6_ENTRY.items()}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class RediShard:
    """A rank's shard of a RediOperator (global topology) and the static
    lines of its neighbours: `coef` (east, west, north, south) as (2, nz,
    ny_l), (4, nz, ny_l), (2, nz, nx_l), (4, nz, nx_l) — cz_u, cz_d, then
    ae, s_e (west) or an, s_n (south); `planes` (inv_de of the west
    neighbours (ny_l,), inv_dn of the south ones (nx_l,)); `wet`, four
    (nz, L) bool lines."""

    op: RediOperator
    coef: tuple
    planes: tuple
    wet: tuple
    s_edge: bool
    n_edge: bool


def redi_shard(op: RediOperator, grid: ProcessGrid) -> RediShard:
    """Exchange the static lines of this rank's operator shard `op`
    (`shard_pytree(op, grid, op.topology.shape2d)`): one round, once per
    operator. Collective."""
    topo = op.topology
    if topo.kind == UNKNOWN:
        raise ValueError("redi_shard: unknown grid topology")
    nz, ny, nx = op.wet.shape
    if (ny, nx) != grid.local_shape(topo.ny, topo.nx):
        raise ValueError(f"redi_shard: op has shape {tuple(op.wet.shape)}, not this rank's shard "
                         f"of {topo.shape3d}")
    dtype = op.ae.dtype
    col = lambda i, names: [getattr(op, n)[:, :, i] for n in names]
    row = lambda j, names: [getattr(op, n)[:, j, :] for n in names]

    def pack(fields, wet, plane=None):
        parts = [torch.stack(fields).reshape(-1), wet.to(dtype).reshape(-1)]
        return torch.cat(parts + ([] if plane is None else [plane]))

    dz = ("cz_u", "cz_d")
    flip = lambda t: torch.flip(t, dims=(-1,))
    pending = _exchange(
        grid,
        pack(col(0, dz), op.wet[:, :, 0]),
        pack(col(-1, dz + ("ae", "s_e")), op.wet[:, :, -1], op.inv_de[:, -1]),
        pack(row(0, dz), op.wet[:, 0, :]),
        pack(row(-1, dz + ("an", "s_n")), op.wet[:, -1, :], op.inv_dn[-1]),
        pack([flip(t) for t in row(-1, dz)], flip(op.wet[:, -1, :])) if topo.is_tripolar
        else None)
    east, west, north, south = pending.wait()

    def unpack(flat, nf, length, plane):
        a, b = nf * nz * length, (nf + 1) * nz * length
        return (flat[:a].reshape(nf, nz, length), flat[a:b].reshape(nz, length).to(torch.bool),
                flat[b:] if plane else None)

    (ce, we, _), (cw, ww, ide_w) = unpack(east, 2, ny, False), unpack(west, 4, ny, True)
    (cn, wn, _), (cs, ws, idn_s) = unpack(north, 2, nx, False), unpack(south, 4, nx, True)
    return RediShard(op, (ce, cw, cn, cs), (ide_w, idn_s), (we, ww, wn, ws),
                     s_edge=grid.y > 0, n_edge=not grid.is_top or topo.is_tripolar)


def _ring(interior: torch.Tensor, east=None, west=None, north=None, south=None):
    """`interior` (..., ny, nx) inside a one-cell ring: the given lines on
    their sides, zeros (False) elsewhere and at the corners."""
    *lead, ny, nx = interior.shape
    box = torch.zeros((*lead, ny + 2, nx + 2), dtype=interior.dtype, device=interior.device)
    box[..., 1:-1, 1:-1] = interior
    for line, at in ((east, (slice(1, -1), -1)), (west, (slice(1, -1), 0)),
                     (north, (-1, slice(1, -1))), (south, (0, slice(1, -1)))):
        if line is not None:
            box[(..., *at)] = line
    return box


def _redi_plain(rs: RediShard, chi: torch.Tensor, chi_halos) -> torch.Tensor:
    """K9's plain version: `redi_apply` on the shard inside a ring made of
    the lines, then the ring cropped. Every value it reads in the ring is
    the neighbour's, and a value derived in the ring (dcz, the west and
    south faces' fluxes) from ring reads in the same column or from the
    shard's own cells; so each shard's result equals `redi_apply` on the
    whole field."""
    op = rs.op
    (ce, cw, cn, cs), (ide_w, idn_s), (we, ww, wn, ws) = rs.coef, rs.planes, rs.wet
    ring_of = {
        "cz_u": dict(east=ce[0], west=cw[0], north=cn[0], south=cs[0]),
        "cz_d": dict(east=ce[1], west=cw[1], north=cn[1], south=cs[1]),
        "ae": dict(west=cw[2]), "s_e": dict(west=cw[3]), "inv_de": dict(west=ide_w),
        "an": dict(south=cs[2]), "s_n": dict(south=cs[3]), "inv_dn": dict(south=idn_s),
    }
    fields = {name: _ring(getattr(op, name), **ring_of.get(name, {})) for name in _COEF_FIELDS}
    nz, ny, nx = op.wet.shape
    box_op = dataclasses.replace(
        op, **fields, wet=_ring(op.wet, we, ww, wn, ws),
        topology=GridTopology(kind=BIPOLAR, nx=nx + 2, ny=ny + 2, nz=nz))
    e, w, n, s = chi_halos
    return redi_apply(box_op, _ring(chi, e, w, n, s))[..., 1:-1, 1:-1].contiguous()


def _launch(rs: RediShard, chi: torch.Tensor, halos) -> torch.Tensor:
    """One K9 launch on a shard whose chi lines have landed (no messages)."""
    o = rs.op
    nz, ny, nx = chi.shape
    out = torch.empty_like(chi)
    keep = [t.contiguous() for t in (*rs.coef, *rs.planes, *rs.wet, *halos)]
    lines = (ctypes.c_void_p * len(keep))(*(t.data_ptr() for t in keep))
    fields = (ctypes.c_void_p * len(_COEF_FIELDS))(
        *(getattr(o, name).data_ptr() for name in _COEF_FIELDS))
    _build.launch(_ENTRY[(o.ae.dtype, chi.dtype)], _ARGTYPES, chi.device,
                  ctypes.cast(fields, ctypes.c_void_p), o.wet.data_ptr(), chi.data_ptr(),
                  out.data_ptr(), ctypes.cast(lines, ctypes.c_void_p), nz, ny, nx,
                  int(rs.s_edge), int(rs.n_edge))
    return out


def redi_apply_halo(op, chi: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
    """d(chi)/dt of Redi isoneutral diffusion on this rank's shard, one
    tracer (nz, ny_l, nx_l): one exchange of chi's lines, then one K9
    launch. `op` is a `RediShard` (`redi_shard`), or this rank's
    RediOperator shard, whose static lines are then exchanged first (an
    extra round). Collective."""
    rs = op if isinstance(op, RediShard) else redi_shard(op, grid)
    o = rs.op
    key = (o.ae.dtype, chi.dtype)
    if key not in _ENTRY:
        raise TypeError(f"redi_apply_halo: no kernel for (coefficients, values) = {key}")
    if tuple(chi.shape) != tuple(o.wet.shape) or chi.device != o.wet.device:
        raise ValueError(f"redi_apply_halo: chi is {tuple(chi.shape)} on {chi.device}, the "
                         f"operator's shard {tuple(o.wet.shape)} on {o.wet.device}")
    chi = chi.contiguous()
    halos = _halo_exchange(chi, o.topology, grid).wait()
    if not chi.is_cuda:
        return _redi_plain(rs, chi, halos)
    return _launch(rs, chi, halos)
