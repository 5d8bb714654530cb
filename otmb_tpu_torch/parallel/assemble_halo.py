"""K8: the fused assembly of T on one shard of a process grid.

Replaces `otmb_tpu/parallel/assemble_halo.py` (`assemble_T_halo_pallas`).
Every cross-shard read of the assembly is a one-cell line that one
exchange round delivers (`parallel/halo._exchange`): per level, v3d, the
transport (umo across x, vmo across y) and in 3D-rho mode rho; per column
or row, 1/area and the edge length that enters the neighbour's face area.
Across the tripolar fold the top shard row receives its mirror shard's top
row, i-reversed, with that row's north edges. These are the raw inputs K4
reads at a neighbour, so K8 (`csrc/assemble.cu`, the kShard instantiation
of K4) runs K4's own expressions on them and equals K4 on the whole field
bit for bit; the JAX kernel exchanges derived lines instead.

A CUDA grid goes to K8, and a failure raises; a CPU grid takes the plain
version, `_assemble_plain`, a transcription of K4's expressions into
torch over whole levels (the body of `_assembly_kernel_shard`), which
matches K8 bit for bit on the card. Against the single-device plain
assembly (`assemble_transport(...).T`) both agree to rounding, as K4 does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..config import KAPPA_H_DEFAULT, KAPPA_VDEEP_DEFAULT, KAPPA_VML_DEFAULT, RHO_DEFAULT
from ..grid.geometry import GridMetrics
from ..grid.topology import BIPOLAR, TRIPOLAR
from ..ops.assemble import _prep
from ..ops.coeffs import StencilCoeffs
from .halo import _exchange
from .mesh import ProcessGrid, all_reduce_sum

_ENTRY = {torch.float32: "otmb_assemble_halo_f32", torch.float64: "otmb_assemble_halo_f64"}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_double]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])

# Rows of `ops.assemble._residents`.
_EDGE_E, _EDGE_W, _EDGE_N, _EDGE_S, _INV_AREA = 0, 1, 2, 3, 9


def _lines(v3dw, umo, vmo, rho, residents, topology, grid):
    """Exchange the lines K4 reads beyond the shard's edges. Returns, in
    the kernel's order, (east, west, north, south) per level as (F, nz, L)
    with fields v3d, the transport and rho, then the same sides' (2, L)
    resident lines (1/area, the neighbour's edge)."""
    inva = residents[_INV_AREA]
    edge = residents[:4]
    level = [v3dw, umo, vmo] + ([] if rho is None else [rho])

    def pack(cols_or_rows, static):
        return torch.cat([torch.stack(cols_or_rows).reshape(-1), torch.stack(static).reshape(-1)])

    col = lambda i: [f[:, :, i] for f in (level[0], level[1], *level[3:])]
    row = lambda j: [f[:, j, :] for f in (level[0], level[2], *level[3:])]
    send_w = pack(col(0), [inva[:, 0], edge[_EDGE_W][:, 0]])
    send_e = pack(col(-1), [inva[:, -1], edge[_EDGE_E][:, -1]])
    send_s = pack(row(0), [inva[0], edge[_EDGE_S][0]])
    send_n = pack(row(-1), [inva[-1], edge[_EDGE_N][-1]])
    fold = None
    if topology.is_tripolar:
        flip = lambda t: torch.flip(t, dims=(-1,))
        fold = pack([flip(r) for r in row(-1)], [flip(inva[-1]), flip(edge[_EDGE_N][-1])])
    east, west, north, south = _exchange(grid, send_w, send_e, send_s, send_n, fold).wait()
    nz, ny, nx = v3dw.shape
    nf = len(level) - 1

    def unpack(flat, length):
        n = nf * nz * length
        return flat[:n].reshape(nf, nz, length), flat[n:].reshape(2, length)

    (e, re), (w, rw), (n, rn), (s, rs) = (unpack(east, ny), unpack(west, ny),
                                          unpack(north, nx), unpack(south, nx))
    return (e, w, n, s), (re, rw, rn, rs)


def _assemble_plain(umo, vmo, v3dw, rho, residents, levels, lines, s_edge: bool,
                    n_interior: bool, tripolar: bool, upwind: bool, inv_rho: float):
    """K8's plain version: K4's expressions (`csrc/assemble.cu`) in its
    order, over whole levels of the shard, its edge neighbours from
    `lines`; the vertical closure is carried level by level from the
    floor, as K4 carries it."""
    (le, lw, ln, ls), (re, rw, rn, rs) = lines
    nz, ny, nx = v3dw.shape
    dt, dev = v3dw.dtype, v3dw.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    # neighbours within a level: the next cell, or the line beyond the edge;
    # the south neighbour of the global south row is the cell itself, as in K4
    nb_e = lambda f, line: torch.cat([f[..., 1:], line[..., None]], dim=-1)
    nb_w = lambda f, line: torch.cat([line[..., None], f[..., :-1]], dim=-1)
    nb_n = lambda f, line: torch.cat([f[..., 1:, :], line[..., None, :]], dim=-2)
    nb_s = lambda f, line: torch.cat([line[..., None, :] if s_edge else f[..., :1, :],
                                      f[..., :-1, :]], dim=-2)
    jj = torch.arange(ny, device=dev).view(1, ny, 1)
    has_s = (jj > 0) | s_edge
    interior_n = (jj + 1 < ny) | n_interior
    has_n = interior_n | tripolar
    not_surf = (torch.arange(nz, device=dev) > 0).to(dt).view(nz, 1, 1)

    wet_of = lambda v: torch.where(torch.isnan(v), zero, one)
    clean_of = lambda v: torch.where(torch.isnan(v), one, v)
    sanitize = lambda x: torch.where(torch.isfinite(x), x, zero)
    if upwind:
        pos = lambda x: torch.where(x > 0, x, zero)
        neg = lambda x: -torch.where(x < 0, x, zero)
    else:
        pos = lambda x: x * 0.5
        neg = lambda x: x * -0.5
    below = lambda f, floor: torch.cat([f[1:], floor], dim=0)  # level k+1
    floor0 = torch.zeros((1, ny, nx), dtype=dt, device=dev)

    v = v3dw
    wetf = wet_of(v)
    vclean = clean_of(v)
    inv_v = wetf / vclean
    v_e, v_w, v_n, v_s = nb_e(v, le[0]), nb_w(v, lw[0]), nb_n(v, ln[0]), nb_s(v, ls[0])
    wetf_e, wetf_w = wet_of(v_e), wet_of(v_w)
    wetf_n = torch.where(has_n, wet_of(v_n), zero)
    wetf_s = torch.where(has_s, wet_of(v_s), zero)
    wetuf = torch.cat([floor0, wetf[:-1]], dim=0)

    # face fluxes
    mask_e, mask_n = wetf * wetf_e, wetf * wetf_n
    mask_w, mask_s = wetf * wetf_w, wetf * wetf_s
    phi_e = sanitize(umo) * mask_e
    phi_n = sanitize(vmo) * mask_n
    phi_w = sanitize(nb_w(umo, lw[1])) * (wetf_w * wetf)
    phi_s = torch.where(has_s, sanitize(nb_s(vmo, ls[1])) * (wetf_s * wetf), zero)
    div = phi_w + phi_s - phi_e - phi_n
    phi_t = torch.empty_like(div)
    carry = floor0[0]
    for k in range(nz - 1, -1, -1):
        carry = carry + div[k]
        phi_t[k] = carry
    phi_b = below(phi_t, floor0)

    # advection
    in_e, in_w = neg(phi_e), pos(phi_w)
    in_n, in_s = neg(phi_n), pos(phi_s)
    in_b = pos(phi_b)
    in_t = not_surf * neg(phi_t)
    seam = neg(sanitize(nb_n(vmo, ln[1])) * (wetf_n * wetf))
    out_n = torch.where(interior_n, pos(phi_n), seam if tripolar else zero)
    if rho is not None:
        half = 0.5
        rho_n = torch.where(has_n, nb_n(rho, ln[2]), one)
        rho_up = torch.cat([rho[:1], rho[:-1]], dim=0)
        im_e = inv_v / ((rho + nb_e(rho, le[2])) * half)
        im_w = inv_v / ((rho + nb_w(rho, lw[2])) * half)
        im_n = inv_v / ((rho + rho_n) * half)
        im_s = inv_v / ((rho + nb_s(rho, ls[2])) * half)
        im_t = inv_v / ((rho + rho_up) * half)
        im_b = inv_v / ((rho + below(rho, floor0)) * half)
        adv_diag = (pos(phi_e) * im_e + neg(phi_w) * im_w + neg(phi_s) * im_s + out_n * im_n
                    + neg(phi_b) * im_b + not_surf * pos(phi_t) * im_t)
    else:
        inv_m = inv_v * torch.tensor(inv_rho, dtype=dt, device=dev)
        im_e = im_w = im_n = im_s = im_t = im_b = inv_m
        out_sum = (pos(phi_e) + neg(phi_w) + neg(phi_s) + out_n + neg(phi_b)
                   + not_surf * pos(phi_t))
        adv_diag = out_sum * inv_m

    # horizontal diffusion, min-face-area rule
    el_e, el_w, el_n, el_s = residents[:4]
    khd_e, khd_w, khd_n, khd_s = residents[4:8]
    area, inva, ml = residents[8], residents[9], residents[10]
    thk = vclean * inva
    p_e, p_w, p_n, p_s = thk * el_e, thk * el_w, thk * el_n, thk * el_s
    a_nb_e = (clean_of(v_e) * nb_e(inva, re[0])) * nb_e(el_w, re[1])
    a_nb_w = (clean_of(v_w) * nb_w(inva, rw[0])) * nb_w(el_e, rw[1])
    a_nb_n = torch.where(has_n, (clean_of(v_n) * nb_n(inva, rn[0])) * nb_n(el_s, rn[1]), zero)
    a_nb_s = torch.where(has_s, (clean_of(v_s) * nb_s(inva, rs[0])) * nb_s(el_n, rs[1]), p_n)
    tv_e = torch.minimum(p_e, a_nb_e) * khd_e * inv_v * mask_e
    tv_w = torch.minimum(p_w, a_nb_w) * khd_w * inv_v * mask_w
    tv_n = torch.minimum(p_n, a_nb_n) * khd_n * inv_v * mask_n
    tv_s = torch.minimum(p_s, a_nb_s) * khd_s * inv_v * mask_s

    # vertical diffusion
    lv = [levels[:, f].view(nz, 1, 1) for f in range(6)]
    om_up = torch.where(lv[0] < ml, one, zero)
    om_dn = torch.where(lv[1] < ml, one, zero)
    a_over_v = area * inv_v
    tot_up = a_over_v * (lv[2] + lv[3] * om_up) * (wetf * wetuf)
    tot_dn = a_over_v * (lv[4] + lv[5] * om_dn) * (wetf * below(wetf, floor0))

    return StencilCoeffs(
        diag=adv_diag + tv_e + tv_w + tv_n + tv_s + tot_up + tot_dn,
        east=-(in_e * im_e) - tv_e,
        west=-(in_w * im_w) - tv_w,
        north=-(in_n * im_n) - tv_n,
        south=-(in_s * im_s) - tv_s,
        top=-(in_t * im_t) - tot_up,
        bottom=-(in_b * im_b) - tot_dn,
    )


class _Shard(NamedTuple):
    """One shard's assembly inputs with its exchanged lines: the arguments
    of `_assemble_plain` and of K8."""

    umo: torch.Tensor
    vmo: torch.Tensor
    v3dw: torch.Tensor
    rho: torch.Tensor | None
    residents: torch.Tensor
    levels: torch.Tensor
    lines: tuple
    s_edge: bool
    n_interior: bool
    tripolar: bool
    upwind: bool
    inv_rho: float


def _launch(a: _Shard) -> StencilCoeffs:
    """One K8 launch on a prepared shard (no messages)."""
    nz, ny, nx = a.v3dw.shape
    dtype, device = a.v3dw.dtype, a.v3dw.device
    keep = [t.contiguous() for t in (*a.lines[0], *a.lines[1])]
    table = (ctypes.c_void_p * len(keep))(*(t.data_ptr() for t in keep))
    out = torch.empty((7, nz, ny, nx), dtype=dtype, device=device)
    _build.launch(
        _ENTRY[dtype], _ARGTYPES, device,
        a.umo.data_ptr(), a.vmo.data_ptr(), a.v3dw.data_ptr(),
        None if a.rho is None else a.rho.data_ptr(),
        a.residents.data_ptr(), a.levels.data_ptr(), out.data_ptr(),
        ctypes.cast(table, ctypes.c_void_p), nz, ny, nx, int(a.tripolar), int(a.upwind),
        a.inv_rho, int(a.s_edge), int(a.n_interior),
    )
    return StencilCoeffs(*out.unbind(0))


def _prepare(umo, vmo, mlotst, gridmetrics: GridMetrics, grid: ProcessGrid, wet3d, rho,
             kappa_h, kappa_vml, kappa_vdeep, upwind) -> _Shard:
    """Check and prepare one shard's inputs and exchange its lines
    (collective)."""
    topo = gridmetrics.topology
    if topo.kind not in (BIPOLAR, TRIPOLAR):
        raise ValueError(f"assemble_T_halo: no kernel for topology {topo.kind!r}")
    v3d = gridmetrics.v3d
    dtype, device = v3d.dtype, v3d.device
    if dtype not in _ENTRY:
        raise TypeError(f"assemble_T_halo: no kernel for {dtype}")
    ny_l, nx_l = grid.local_shape(topo.ny, topo.nx)
    shape3, shape2 = (topo.nz, ny_l, nx_l), (ny_l, nx_l)

    def as_local(x, name, shape):
        if isinstance(x, torch.Tensor) and x.device != device:
            raise ValueError(f"assemble_T_halo: {name} is on {x.device}, the grid on {device}")
        t = torch.as_tensor(x, dtype=dtype, device=device)
        if tuple(t.shape) != shape:
            raise ValueError(f"assemble_T_halo: {name} has shape {tuple(t.shape)}, expected "
                             f"{shape} on this shard")
        return t.contiguous()

    if tuple(v3d.shape) != shape3:
        raise ValueError(f"assemble_T_halo: v3d has shape {tuple(v3d.shape)}, expected {shape3}: "
                         f"pass this rank's shard of the grid metrics")
    umo, vmo = as_local(umo, "umo", shape3), as_local(vmo, "vmo", shape3)
    ml = as_local(mlotst, "mlotst", shape2)
    rho3d = None
    if isinstance(rho, (torch.Tensor, np.ndarray)) and rho.ndim == 3:
        rho3d = as_local(rho, "rho", shape3)
    v3dw = v3d if wet3d is None else torch.where(
        torch.as_tensor(wet3d, device=device).to(torch.bool), v3d, float("nan"))
    v3dw = v3dw.contiguous()
    bad = 0.0
    if rho3d is not None:
        bad = float((torch.isnan(rho3d) & ~torch.isnan(v3dw)).any())
    if float(all_reduce_sum(torch.tensor([bad], dtype=torch.float64), grid)) > 0:
        raise FloatingPointError("rho contains NaNs on wet cells (reference matrixbuilding.jl:233)")

    residents, levels = _prep(gridmetrics, ml, float(kappa_h), float(kappa_vml),
                              float(kappa_vdeep))
    # Land densities are inert (their faces carry zero flux) but must be finite.
    rho_clean = None if rho3d is None else torch.where(torch.isnan(rho3d), 1.0, rho3d)
    lines = _lines(v3dw, umo, vmo, rho_clean, residents, topo, grid)
    return _Shard(umo, vmo, v3dw, rho_clean, residents, levels, lines, grid.y > 0,
                  not grid.is_top, topo.is_tripolar, bool(upwind),
                  0.0 if rho3d is not None else 1.0 / float(rho))


def assemble_T_halo(umo, vmo, mlotst, gridmetrics: GridMetrics, grid: ProcessGrid,
                    wet3d=None, rho=RHO_DEFAULT, kappa_h=KAPPA_H_DEFAULT,
                    kappa_vml=KAPPA_VML_DEFAULT, kappa_vdeep=KAPPA_VDEEP_DEFAULT,
                    upwind: bool = True) -> StencilCoeffs:
    """This rank's shard of T = Tadv + TkH + TkVML + TkVdeep, assembled
    from its shards of umo, vmo, mlotst, the grid metrics
    (`shard_pytree(gm, grid, gm.topology.shape2d)`: the topology stays the
    global one) and `wet3d` (None: the NaN pattern of v3d). `rho` is a
    scalar or the rank's shard of a 3D field; `upwind` as `assemble_T`.
    Collective: every rank calls it, and one exchange round carries the
    lines."""
    a = _prepare(umo, vmo, mlotst, gridmetrics, grid, wet3d, rho, kappa_h, kappa_vml,
                 kappa_vdeep, upwind)
    if not a.v3dw.is_cuda:
        return _assemble_plain(*a)
    return _launch(a)
