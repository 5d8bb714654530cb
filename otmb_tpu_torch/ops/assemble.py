"""K4: fused assembly of the whole operator T from raw transports.

Replaces `otmb_tpu/ops/assemble_pallas.py:assemble_T_pallas` with the CUDA
kernels of `csrc/assemble.cu`: the prep entry writes the O(nz) and
O(ny*nx) preparation in one launch (per-level kappa/dz rows with an
infinite dz at the boundaries, which makes kappa/dz exactly 0; finite
resident metric fields; plain version `_levels` and `_residents`, the JAX
package's `_prep_kpack_residents`), then K4 writes the seven legs of
T = Tadv + TkH + TkVML + TkVdeep.

A CUDA grid goes to the kernel; a CPU grid takes the plain version,
`models.transport.assemble_transport(...).T`. The two agree to rounding:
the kernel forms the masses and face areas in another order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..config import KAPPA_H_DEFAULT, KAPPA_VDEEP_DEFAULT, KAPPA_VML_DEFAULT, RHO_DEFAULT
from ..grid.geometry import GridMetrics
from ..grid.topology import BIPOLAR, TRIPOLAR
from ..models.transport import assemble_transport
from ..utils.tracing import traced
from .coeffs import StencilCoeffs

_ENTRY = {torch.float32: "otmb_assemble_f32", torch.float64: "otmb_assemble_f64"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_void_p]
_PREP_ENTRY = {torch.float32: "otmb_assemble_prep_f32", torch.float64: "otmb_assemble_prep_f64"}
_PREP_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_double] * 3 + [
    ctypes.c_void_p]


def _levels(zt: torch.Tensor, kappa_vml: float, kappa_vdeep: float) -> torch.Tensor:
    """(nz, 6) rows: max depth of the k/k-1 and k/k+1 pairs (the
    mixed-layer test zt[k] < ml and zt[k'] < ml is max < ml), then
    kappa_vdeep/dz and kappa_vml/dz up and down. dz is infinite where no
    vertical neighbour exists, so those kappa/dz are exactly 0."""
    inf = torch.full_like(zt[:1], float("inf"))
    z_up = torch.cat([zt[:1], zt[:-1]])
    z_dn = torch.cat([zt[1:], zt[-1:]])
    dz_up = torch.cat([inf, torch.abs(zt - z_up)[1:]])
    dz_dn = torch.cat([torch.abs(zt - z_dn)[:-1], inf])
    zup_max = torch.cat([inf, torch.maximum(zt, z_up)[1:]])
    zdn_max = torch.cat([torch.maximum(zt, z_dn)[:-1], inf])
    over = lambda kappa, dz: torch.full_like(dz, kappa) / dz
    return torch.stack([
        zup_max, zdn_max,
        over(kappa_vdeep, dz_up), over(kappa_vml, dz_up),
        over(kappa_vdeep, dz_dn), over(kappa_vml, dz_dn),
    ], dim=1).contiguous()


def _residents(gm: GridMetrics, ml: torch.Tensor, kappa_h: float) -> torch.Tensor:
    """(11, ny, nx) finite metric fields, in the order csrc/assemble.cu
    reads them: edge lengths E, W, N, S; kappa_h/distance E, W, N, S (0
    where no neighbour); area (0 on land columns); 1/area (0 there); mlotst."""

    def khd(d):
        dist = gm.distance_to_neighbour[d]
        return torch.where(torch.isfinite(dist), torch.full_like(dist, kappa_h) / dist, 0.0)

    area = gm.area2d
    el = gm.edge_length
    return torch.stack([
        el.east, el.west, el.north, el.south,
        khd("east"), khd("west"), khd("north"), khd("south"),
        torch.nan_to_num(area),
        torch.where(torch.isfinite(area), torch.reciprocal(area), 0.0),
        ml,
    ]).contiguous()


def _prep(gm: GridMetrics, ml: torch.Tensor, kappa_h: float, kappa_vml: float,
          kappa_vdeep: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(`_residents`, `_levels`) of a grid (a whole one or a shard): one
    launch of the prep entry on a CUDA grid, equal to the plain versions
    bit for bit; the plain versions on a CPU one."""
    if not ml.is_cuda:
        return _residents(gm, ml, kappa_h), _levels(gm.zt, kappa_vml, kappa_vdeep)
    el, dist = gm.edge_length, gm.distance_to_neighbour
    sides = ("east", "west", "north", "south")
    fields = [t.contiguous() for t in (*(el[d] for d in sides), *(dist[d] for d in sides),
                                       gm.area2d, ml, gm.zt)]
    for t in fields:
        if t.dtype != ml.dtype or t.device != ml.device:
            raise ValueError(f"assemble prep: a grid field is {t.dtype} on {t.device}, "
                             f"expected {ml.dtype} on {ml.device}")
    nz = gm.zt.shape[0]
    ny, nx = ml.shape
    residents = torch.empty((11, ny, nx), dtype=ml.dtype, device=ml.device)
    levels = torch.empty((nz, 6), dtype=ml.dtype, device=ml.device)
    table = (ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in fields))
    _build.launch(_PREP_ENTRY[ml.dtype], _PREP_ARGTYPES, ml.device,
                  ctypes.cast(table, ctypes.c_void_p), residents.data_ptr(), levels.data_ptr(),
                  nz, ny, nx, float(kappa_h), float(kappa_vml), float(kappa_vdeep))
    return residents, levels


@traced
def assemble_T(umo, vmo, mlotst, gridmetrics: GridMetrics, wet3d=None,
               rho=RHO_DEFAULT, kappa_h=KAPPA_H_DEFAULT, kappa_vml=KAPPA_VML_DEFAULT,
               kappa_vdeep=KAPPA_VDEEP_DEFAULT, upwind: bool = True) -> StencilCoeffs:
    """Total operator T from raw umo/vmo/mlotst, physics-identical to
    `assemble_transport(...).T`. `rho` is a scalar or a (nz, ny, nx) field
    (per-face masses from pair means, matrixbuilding.jl:221-225).
    `wet3d=None` means the NaN pattern of v3d; an explicit mask is folded
    into the volumes as NaN. Unknown topology raises."""
    topo = gridmetrics.topology
    if topo.kind not in (BIPOLAR, TRIPOLAR):
        raise ValueError(f"assemble_T: no kernel for topology {topo.kind!r}")
    v3d = gridmetrics.v3d
    dtype, device = v3d.dtype, v3d.device
    if dtype not in _ENTRY:
        raise TypeError(f"assemble_T: no kernel for {dtype}")

    def as_grid(x, name, shape):
        if isinstance(x, torch.Tensor) and x.device != device:
            raise ValueError(f"assemble_T: {name} is on {x.device}, the grid on {device}")
        t = torch.as_tensor(x, dtype=dtype, device=device)
        if tuple(t.shape) != shape:
            raise ValueError(f"assemble_T: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"assemble_T: {name} is not contiguous")
        return t

    umo = as_grid(umo, "umo", topo.shape3d)
    vmo = as_grid(vmo, "vmo", topo.shape3d)
    ml = as_grid(mlotst, "mlotst", topo.shape2d)
    rho3d = None
    if isinstance(rho, (torch.Tensor, np.ndarray)) and rho.ndim == 3:
        rho3d = as_grid(rho, "rho", topo.shape3d)
    v3dw = v3d if wet3d is None else torch.where(
        torch.as_tensor(wet3d, device=device).to(torch.bool), v3d, float("nan"))
    v3dw = v3dw.contiguous()
    # the land mask: for the plain version, and for the 3D-rho check
    land = torch.isnan(v3dw) if rho3d is not None or not v3d.is_cuda else None
    if rho3d is not None and bool((torch.isnan(rho3d) & ~land).any()):
        raise FloatingPointError("rho contains NaNs on wet cells (reference matrixbuilding.jl:233)")

    if not v3d.is_cuda:
        return assemble_transport(
            umo, vmo, ml, gridmetrics, ~land, rho=rho if rho3d is None else rho3d,
            kappa_h=kappa_h, kappa_vml=kappa_vml, kappa_vdeep=kappa_vdeep, upwind=upwind,
        ).T

    nz, ny, nx = topo.shape3d
    residents, levels = _prep(gridmetrics, ml, float(kappa_h), float(kappa_vml),
                              float(kappa_vdeep))
    # Land densities are inert (their faces carry zero flux) but must be finite.
    rho_clean = None if rho3d is None else torch.where(torch.isnan(rho3d), 1.0, rho3d)
    out = torch.empty((7, nz, ny, nx), dtype=dtype, device=device)
    _build.launch(
        _ENTRY[dtype], _ARGTYPES, device,
        umo.data_ptr(), vmo.data_ptr(), v3dw.data_ptr(),
        None if rho_clean is None else rho_clean.data_ptr(),
        residents.data_ptr(), levels.data_ptr(), out.data_ptr(),
        nz, ny, nx, int(topo.is_tripolar), int(bool(upwind)),
        0.0 if rho3d is not None else 1.0 / float(rho),
    )
    return StencilCoeffs(*out.unbind(0))
