"""Derivatives: classic forward/backward, vertical dyads and triads.

Counterpart of `otmb_tpu.ops.derivatives` (reference
classicderivatives.jl, dyads.jl and triads.jl), on the whole grid at
once. "No neighbour" is NaN, as the reference's `getindexornan`, and the
means over one-sided estimates are NaN-aware: the mean of the finite ones,
NaN where none is (the reference's strong-zero `false * NaN == 0`).

Direction names: "i" (zonal, east/west) and "j" (meridional, north/south).
Everything follows the device and dtype of the grid metrics.
"""

from __future__ import annotations

import torch

from ..grid.geometry import GridMetrics
from ..grid.topology import neighbor_values

_FORWARD_DIR = {"i": "east", "j": "north"}
_BACKWARD_DIR = {"i": "west", "j": "south"}


def _nanaware_mean(deltas):
    """Mean of the finite entries; NaN if none (dyads.jl:58-65,
    triads.jl:114-133)."""
    num = 0.0
    den = 0.0
    for d in deltas:
        ok = torch.isfinite(d)
        num = num + torch.where(ok, d, 0.0)
        den = den + ok.to(d.dtype)
    return num / den


def _wet_or_nan(out, wet3d):
    if wet3d is None:
        return out
    return torch.where(torch.as_tensor(wet3d, device=out.device).to(torch.bool), out, torch.nan)


def _dz(gridmetrics: GridMetrics):
    """|z(top) - z| and |z(bottom) - z|, NaN where the level is missing."""
    topo, z = gridmetrics.topology, gridmetrics.z3d
    return (torch.abs(neighbor_values(z, "top", topo) - z),
            torch.abs(neighbor_values(z, "bottom", topo) - z))


# --- classic forward/backward derivatives (classicderivatives.jl) ---------


def horizontal_derivative_forward(chi, gridmetrics: GridMetrics, direction: str):
    """(chi[next] - chi[c]) / haversine distance along `direction` in
    {"i", "j"} (classicderivatives.jl:11-15); NaN where no neighbour."""
    d = _FORWARD_DIR[direction]
    nb = neighbor_values(chi, d, gridmetrics.topology)
    return (nb - chi) / gridmetrics.distance_to_neighbour[d]


def horizontal_derivative_backward(chi, gridmetrics: GridMetrics, direction: str):
    """(chi[c] - chi[previous]) / distance (classicderivatives.jl:16-20)."""
    d = _BACKWARD_DIR[direction]
    nb = neighbor_values(chi, d, gridmetrics.topology)
    return (chi - nb) / gridmetrics.distance_to_neighbour[d]


def vertical_derivative_forward(chi, gridmetrics: GridMetrics):
    """Forward (downward, k+1) vertical derivative on the cell-centre
    depths (classicderivatives.jl:27-31)."""
    topo, z = gridmetrics.topology, gridmetrics.z3d
    nb = neighbor_values(chi, "bottom", topo)
    return (nb - chi) / torch.abs(neighbor_values(z, "bottom", topo) - z)


def vertical_derivative_backward(chi, gridmetrics: GridMetrics):
    """Backward (upward, k-1) vertical derivative (classicderivatives.jl:32-36)."""
    topo, z = gridmetrics.topology, gridmetrics.z3d
    nb = neighbor_values(chi, "top", topo)
    return (chi - nb) / torch.abs(neighbor_values(z, "top", topo) - z)


# --- vertical dyads (dyads.jl) --------------------------------------------


def vertical_dyad_derivative(chi, gridmetrics: GridMetrics, wet3d=None):
    """NaN-aware mean of the upward and downward vertical derivatives
    (`globalverticaldyadderivative`, dyads.jl:66-78): the dyad's "N" is
    k-1 (above) and "S" k+1 (below); NaN outside `wet3d` if given."""
    topo = gridmetrics.topology
    chi_up = neighbor_values(chi, "top", topo)
    chi_dn = neighbor_values(chi, "bottom", topo)
    dz_up, dz_dn = _dz(gridmetrics)
    out = _nanaware_mean([(chi_up - chi) / dz_up, (chi - chi_dn) / dz_dn])
    return _wet_or_nan(out, wet3d)


# --- triads (triads.jl) ---------------------------------------------------


def centered_triad_derivative(chi, gridmetrics: GridMetrics, direction: str, wet3d=None):
    """NaN-aware mean of the 4 one-sided slopes of the centred triad group
    (E, W horizontal; N = k-1, S = k+1 vertical), as
    `localtriadderivative(::CenteredTriadGroupValues)` (triads.jl:57-66)."""
    topo = gridmetrics.topology
    fwd, bwd = _FORWARD_DIR[direction], _BACKWARD_DIR[direction]
    chi_e = neighbor_values(chi, fwd, topo)
    chi_w = neighbor_values(chi, bwd, topo)
    d_e = gridmetrics.distance_to_neighbour[fwd]
    d_w = gridmetrics.distance_to_neighbour[bwd]
    chi_n = neighbor_values(chi, "top", topo)
    chi_s = neighbor_values(chi, "bottom", topo)
    dz_n, dz_s = _dz(gridmetrics)
    out = _nanaware_mean([
        (chi_e - chi) / d_e,
        (chi - chi_w) / d_w,
        (chi_n - chi) / dz_n,
        (chi - chi_s) / dz_s,
    ])
    return _wet_or_nan(out, wet3d)


def vertical_face_triad_group_distances(gridmetrics: GridMetrics, direction: str):
    """The distances of the 6-point vertical-face triad group as seen from
    every centre cell (`verticalfacetriadgroupdistances`, triads.jl:103-112):
    CN = |Z[N] - Z[C]| (N is k-1), CS = |Z[C] - Z[S]| (S is k+1), CE the
    haversine distance in `direction`, ENE and ESE the E column's legs."""
    topo = gridmetrics.topology
    fwd = _FORWARD_DIR[direction]
    dz_up, dz_dn = _dz(gridmetrics)
    return {
        "CN": dz_up,
        "CS": dz_dn,
        "CE": gridmetrics.distance_to_neighbour[fwd],
        "ENE": neighbor_values(dz_up, fwd, topo),
        "ESE": neighbor_values(dz_dn, fwd, topo),
    }


def vertical_face_triad_derivative_group(vals, gridmetrics: GridMetrics, direction: str,
                                         wet3d=None):
    """Triad slope from per-centre group values `vals` (tags C, N, S, E,
    NE, SE, each (nz, ny, nx) as seen from every centre cell): the array
    form of `localtriadderivative(::VerticalFaceTriadGroupValues)`
    (triads.jl:114-133), for fields such as potential density referenced
    to the centre's depth."""
    d = vertical_face_triad_group_distances(gridmetrics, direction)
    d_cn = (vals["N"] - vals["C"]) / d["CN"]
    d_cs = (vals["C"] - vals["S"]) / d["CS"]
    d_ce = (vals["E"] - vals["C"]) / d["CE"]
    d_ene = (vals["NE"] - vals["E"]) / d["ENE"]
    d_ese = (vals["E"] - vals["SE"]) / d["ESE"]
    out = _nanaware_mean([d_ce / d_cn, d_ce / d_cs, d_ce / d_ene, d_ce / d_ese])
    return _wet_or_nan(out, wet3d)


def vertical_face_triad_group_values(chi, gridmetrics: GridMetrics, direction: str):
    """The 6 group-member fields of one array `chi`
    (`verticalfacetriadgroupvalues`, triads.jl:90-102): per centre cell,
    the values at C, N (k-1), S (k+1), E (the `direction` neighbour), NE, SE."""
    topo = gridmetrics.topology
    fwd = _FORWARD_DIR[direction]

    def at(arr, *dirs):
        for dd in dirs:
            arr = neighbor_values(arr, dd, topo)
        return arr

    return {
        "C": chi,
        "N": at(chi, "top"),
        "S": at(chi, "bottom"),
        "E": at(chi, fwd),
        "NE": at(chi, fwd, "top"),
        "SE": at(chi, fwd, "bottom"),
    }


def vertical_face_triad_derivative(chi, gridmetrics: GridMetrics, direction: str, wet3d=None):
    """Isoneutral slope on the vertical face in `direction`
    (`globalverticalfacetriadderivative`, triads.jl:134-146): the NaN-aware
    mean of the four ratios CE/CN, CE/CS, CE/ENE, CE/ESE of the 6-point
    group; NaN outside `wet3d` if given."""
    topo = gridmetrics.topology
    fwd = _FORWARD_DIR[direction]
    chi_up = neighbor_values(chi, "top", topo)
    chi_dn = neighbor_values(chi, "bottom", topo)
    dz_up, dz_dn = _dz(gridmetrics)
    d_cn = (chi_up - chi) / dz_up
    d_cs = (chi - chi_dn) / dz_dn
    chi_e = neighbor_values(chi, fwd, topo)
    d_ce = (chi_e - chi) / gridmetrics.distance_to_neighbour[fwd]
    d_ene = neighbor_values(d_cn, fwd, topo)
    d_ese = neighbor_values(d_cs, fwd, topo)
    out = _nanaware_mean([d_ce / d_cn, d_ce / d_cs, d_ce / d_ene, d_ce / d_ese])
    return _wet_or_nan(out, wet3d)
