"""The plain reference of the neutral physics: the density path, the GM
bolus transports, the Redi operator and explicit T + R steps, in float64
on dense (nz, ny, nx) fields.

Independent of the program: it imports nothing of it (nor JAX), takes
nothing the program made, and writes each piece from its published
definition.

  * TEOS-10 in-situ density: the polyTEOS10-bsq polynomial of Roquet,
    Madec, McDougall & Barker (2015, Ocean Modelling 90, Appendix A.2),
    its own copy of the published coefficients (the 52 R_ijk and the 6 of
    the reference profile r0), summed term by term, not in Horner form.
  * Isoneutral slopes: vertical-face triads (OceanTransportMatrixBuilder.jl
    triads.jl:90-146) of the locally referenced potential density
    (RediGM.jl:17-35): for every centre cell the six group members' density
    at the centre's depth; the NaN-aware mean of the four ratios
    CE/CN, CE/CS, CE/ENE, CE/ESE.
  * Clamp to +-maxslope, then the tanh taper 0.5 (1 + tanh((Sc - |S|) / Sd))
    (RediGM.jl:56-64).
  * GM bolus velocity: the vertical dyad derivative of kappa_GM S
    (RediGM.jl:46-79, dyads.jl:66-78), turned into east and north face
    mass transports as velocities.jl:10-39 does (the pair's mean density
    and least thickness, the edge length), added to umo and vmo.
  * Redi isoneutral diffusion, d(chi)/dt = div(K grad chi) with the
    small-slope tensor (Redi 1982)

        K = kappa [[1, 0, Sx], [0, 1, Sy], [Sx, Sy, Sx^2 + Sy^2]]

    (x east, y north, zeta up), written face by face: across an east face
    F = kappa A (d_x chi + Sx d_zeta chi), a north face kappa A (d_y chi +
    Sy d_zeta chi), a top face kappa A (Sx d_x chi + Sy d_y chi + S^2
    d_zeta chi); each cell gains what flows in through its six faces, over
    its volume. A face is open only between two wet cells. The choices that
    make this one discretisation (those of the program's docstring,
    `models/redi.py`, which the tensor leaves open) are:
      - the slope across the cell pair: Sx = -rho_x / rho_zeta from the
        triads (NaN read as 0), clamped and tapered at the cells, its face
        value the mean of the two cells' (a dry cell's reading 0);
      - the normal derivative across a face: the difference of the two
        cells over the centres' distance (east and north), or depths (top);
      - a cross derivative at a face: the mean of the two cells' centred
        derivatives, each the mean of the one-sided differences to wet
        neighbours (0 where it has none);
      - the top face's area is the column's horizontal area, an east or
        north face's the shallower cell's thickness times the edge;
      - S^2 at a top face is formed from the face's slopes;
      - across the tripolar seam (north faces of the top row) the cross
        term is left out: j's orientation flips there. The seam face is
        seen from both its cells, each as its own north face.
  * Explicit steps chi <- chi - dt T chi + dt R chi, T through
    `reference.apply`.
"""

from __future__ import annotations

import math

import torch

from . import reference
from .reference import neighbour

NAN = math.nan

# polyTEOS10-bsq (Roquet et al. 2015, Appendix A.2): reduced variables ...
SAU = 40.0 * 35.16504 / 35.0
CTU = 40.0
ZU = 1.0e4
DELTAS = 32.0
# ... the reference profile r0(zz) = sum_n R0[n] zz^(n + 1) ...
R0 = (4.6494977072e01, -5.2099962525e00, 2.2601900708e-01, 6.4326772569e-02,
      1.5616995503e-02, -1.7243708991e-03)
# ... and R_ijk, the coefficient of ss^i tt^j zz^k.
R = {
    (0, 0, 0): 8.0189615746e02, (1, 0, 0): 8.6672408165e02, (2, 0, 0): -1.7864682637e03,
    (3, 0, 0): 2.0375295546e03, (4, 0, 0): -1.2849161071e03, (5, 0, 0): 4.3227585684e02,
    (6, 0, 0): -6.0579916612e01, (0, 1, 0): 2.6010145068e01, (1, 1, 0): -6.5281885265e01,
    (2, 1, 0): 8.1770425108e01, (3, 1, 0): -5.6888046321e01, (4, 1, 0): 1.7681814114e01,
    (5, 1, 0): -1.9193502195e00, (0, 2, 0): -3.7074170417e01, (1, 2, 0): 6.1548258127e01,
    (2, 2, 0): -6.0362551501e01, (3, 2, 0): 2.9130021253e01, (4, 2, 0): -5.4723692739e00,
    (0, 3, 0): 2.1661789529e01, (1, 3, 0): -3.3449108469e01, (2, 3, 0): 1.9717078466e01,
    (3, 3, 0): -3.1742946532e00, (0, 4, 0): -8.3627885467e00, (1, 4, 0): 1.1311538584e01,
    (2, 4, 0): -5.3563304045e00, (0, 5, 0): 5.4048723791e-01, (1, 5, 0): 4.8169980163e-01,
    (0, 6, 0): -1.9083568888e-01, (0, 0, 1): 1.9681925209e01, (1, 0, 1): -4.2549998214e01,
    (2, 0, 1): 5.0774768218e01, (3, 0, 1): -3.0938076334e01, (4, 0, 1): 6.6051753097e00,
    (0, 1, 1): -1.3336301113e01, (1, 1, 1): -4.4870114575e00, (2, 1, 1): 5.0042598061e00,
    (3, 1, 1): -6.5399043664e-01, (0, 2, 1): 6.7080479603e00, (1, 2, 1): 3.5063081279e00,
    (2, 2, 1): -1.8795372996e00, (0, 3, 1): -2.4649669534e00, (1, 3, 1): -5.5077101279e-01,
    (0, 4, 1): 5.5927935970e-01, (0, 0, 2): 2.0660924175e00, (1, 0, 2): -4.9527603989e00,
    (2, 0, 2): 2.5019633244e00, (0, 1, 2): 2.0564311499e00, (1, 1, 2): -2.1311365518e-01,
    (0, 2, 2): -1.2419983026e00, (0, 0, 3): -2.3342758797e-02, (1, 0, 3): -1.8507636718e-02,
    (0, 1, 3): 3.7969820455e-01,
}
assert len(R) == 52


def rho_teos10(sa: torch.Tensor, ct: torch.Tensor, depth) -> torch.Tensor:
    """In-situ density (kg/m^3) of Absolute Salinity `sa` (g/kg),
    Conservative Temperature `ct` (C) at `depth` (m, positive down)."""
    sa, ct = sa.to(torch.float64), ct.to(torch.float64)
    depth = torch.as_tensor(depth, dtype=torch.float64, device=sa.device)
    ss = torch.sqrt((sa + DELTAS) / SAU)
    tt = ct / CTU
    zz = depth / ZU
    out = sum(r * zz ** (n + 1) for n, r in enumerate(R0))
    for (i, j, k), r in R.items():
        out = out + r * ss ** i * tt ** j * zz ** k
    return out


FORWARD = {"i": "east", "j": "north"}


def _nanmean(values) -> torch.Tensor:
    """The mean of the finite values, NaN where none is."""
    num = sum(torch.where(torch.isfinite(v), v, 0.0) for v in values)
    den = sum(torch.isfinite(v).to(torch.float64) for v in values)
    return num / den


def _nb(x, d, tripolar):
    """`d`-neighbour's value, NaN where there is none."""
    return neighbour(x, d, tripolar, NAN)


def neutral_slope(sa, ct, grid: dict, wet, direction: str, tripolar: bool) -> torch.Tensor:
    """Triad slope rho_x / rho_zeta (x the `direction`'s axis) of the locally
    referenced potential density, NaN on land and where no triad is."""
    fwd = FORWARD[direction]
    sa, ct = sa.to(torch.float64), ct.to(torch.float64)
    z = grid["z3d"]
    members = {"C": (sa, ct), "N": (_nb(sa, "top", tripolar), _nb(ct, "top", tripolar)),
               "S": (_nb(sa, "bottom", tripolar), _nb(ct, "bottom", tripolar))}
    e_sa, e_ct = _nb(sa, fwd, tripolar), _nb(ct, fwd, tripolar)
    members["E"] = (e_sa, e_ct)
    members["NE"] = (_nb(e_sa, "top", tripolar), _nb(e_ct, "top", tripolar))
    members["SE"] = (_nb(e_sa, "bottom", tripolar), _nb(e_ct, "bottom", tripolar))
    rho = {tag: rho_teos10(s, t, z) for tag, (s, t) in members.items()}
    dz_up = (_nb(z, "top", tripolar) - z).abs()
    dz_dn = (_nb(z, "bottom", tripolar) - z).abs()
    dx = grid[f"distance_to_neighbour.{fwd}"]
    d_ce = (rho["E"] - rho["C"]) / dx
    ratios = [d_ce / ((rho["N"] - rho["C"]) / dz_up),
              d_ce / ((rho["C"] - rho["S"]) / dz_dn),
              d_ce / ((rho["NE"] - rho["E"]) / _nb(dz_up, fwd, tripolar)),
              d_ce / ((rho["E"] - rho["SE"]) / _nb(dz_dn, fwd, tripolar))]
    return torch.where(wet, _nanmean(ratios), NAN)


def neutral_slopes(sa, ct, grid, wet, tripolar):
    return (neutral_slope(sa, ct, grid, wet, "i", tripolar),
            neutral_slope(sa, ct, grid, wet, "j", tripolar))


def clamp_taper(s_i, s_j, maxslope: float, sc: float, sd: float):
    """Slopes clipped to +-maxslope, then times the tanh taper of their
    magnitude (NaN stays NaN)."""
    s_i, s_j = s_i.clamp(-maxslope, maxslope), s_j.clamp(-maxslope, maxslope)
    taper = 0.5 * (1.0 + torch.tanh((sc - torch.sqrt(s_i ** 2 + s_j ** 2)) / sd))
    return taper * s_i, taper * s_j


def _dyad(x, grid, wet, tripolar):
    """The NaN-aware mean of the upward and downward one-sided derivatives
    of x with respect to height, NaN on land."""
    z = grid["z3d"]
    up = (_nb(x, "top", tripolar) - x) / (_nb(z, "top", tripolar) - z).abs()
    down = (x - _nb(x, "bottom", tripolar)) / (_nb(z, "bottom", tripolar) - z).abs()
    return torch.where(wet, _nanmean([up, down]), NAN)


def _finite(x):
    """x where finite, else 0 (no transport)."""
    return torch.where(torch.isfinite(x), x, 0.0)


def _pair_mean(x, d, tripolar):
    """The NaN-aware mean of a cell and its `d`-neighbour."""
    return _nanmean([x, _nb(x, d, tripolar)])


def _pair_min(x, d, tripolar):
    """The smaller of a cell's and its `d`-neighbour's, ignoring a NaN."""
    other = _nb(x, d, tripolar)
    return torch.where(torch.isnan(x), other,
                       torch.where(torch.isnan(other), x, torch.minimum(x, other)))


def bolus_transports(umo, vmo, rho, slopes, grid, wet, tripolar, kappa_gm, maxslope, sc, sd):
    """(umo, vmo) plus the GM bolus mass transports (kg/s) of the triad
    slopes `slopes` (unclamped, as `neutral_slopes` gives them); `rho` is
    the density of the velocity-to-transport conversion."""
    s_i, s_j = clamp_taper(*slopes, maxslope, sc, sd)
    thk = grid["thkcello"]
    out = []
    for s, d, raw in ((s_i, "east", umo), (s_j, "north", vmo)):
        u = _finite(_dyad(kappa_gm * s, grid, wet, tripolar))
        phi = (u * _pair_mean(rho, d, tripolar) * _pair_min(thk, d, tripolar)
               * grid[f"edge_length.{d}"])
        out.append(raw.to(torch.float64) + _finite(phi))
    return tuple(out)


class Redi:
    """The Redi operator of tapered cell slopes on one grid: `face_slopes`
    (the slopes on each open face) and `__call__` (d(chi)/dt, one field or a
    batch broadcast over the leading axis)."""

    def __init__(self, slopes, grid, wet, tripolar: bool, kappa: float, maxslope: float,
                 sc: float, sd: float):
        self.grid, self.wet, self.tripolar, self.kappa = grid, wet, tripolar, kappa
        # the cell slopes of the rotated tensor: Sx = -rho_x / rho_zeta
        sx, sy = (_finite(-s) for s in slopes)
        self.sx, self.sy = clamp_taper(sx, sy, maxslope, sc, sd)
        nb = lambda x, d: neighbour(x, d, tripolar, False)
        exists = lambda d: reference.has_neighbour(d, wet.shape, tripolar, wet.device)
        self.open = {"east": wet & nb(wet, "east"), "west": wet & nb(wet, "west"),
                     "north": wet & nb(wet, "north") & exists("north"),
                     "south": wet & nb(wet, "south") & exists("south"),
                     "top": wet & nb(wet, "top"), "bottom": wet & nb(wet, "bottom")}
        self.seam = torch.zeros_like(wet)
        if tripolar:
            self.seam[:, -1, :] = True

    def face_slopes(self) -> dict:
        """The tapered slopes on the open faces, 0 on closed ones: Sx across
        east faces (`s_e`), Sy across north faces (`s_n`, 0 on the seam),
        Sx and Sy on top faces (`s_ti`, `s_tj`)."""
        mean = lambda x, d: 0.5 * (x + neighbour(x, d, self.tripolar, 0.0))
        o = self.open
        return {"s_e": torch.where(o["east"], mean(self.sx, "east"), 0.0),
                "s_n": torch.where(o["north"] & ~self.seam, mean(self.sy, "north"), 0.0),
                "s_ti": torch.where(o["top"], mean(self.sx, "top"), 0.0),
                "s_tj": torch.where(o["top"], mean(self.sy, "top"), 0.0)}

    def _centred(self, chi, fwd: str, bwd: str, dist_f, dist_b) -> torch.Tensor:
        """The mean of the one-sided differences to wet neighbours."""
        t, o = self.tripolar, self.open
        ahead = torch.where(o[fwd], (neighbour(chi, fwd, t) - chi) / torch.where(
            o[fwd], dist_f, 1.0), 0.0)
        behind = torch.where(o[bwd], (chi - neighbour(chi, bwd, t)) / torch.where(
            o[bwd], dist_b, 1.0), 0.0)
        n = o[fwd].to(chi.dtype) + o[bwd].to(chi.dtype)
        return (ahead + behind) / torch.clamp(n, min=1.0)

    def __call__(self, chi: torch.Tensor) -> torch.Tensor:
        g, t, o, kappa = self.grid, self.tripolar, self.open, self.kappa
        chi = torch.where(self.wet, chi.to(torch.float64), 0.0)
        z = g["z3d"]
        dz_up = (neighbour(z, "top", t, NAN) - z).abs()
        dz_dn = (neighbour(z, "bottom", t, NAN) - z).abs()
        d = {s: g[f"distance_to_neighbour.{s}"] for s in ("east", "west", "north", "south")}
        # centred derivatives: upward (zeta), east (x), north (y)
        d_zeta = self._centred(chi, "top", "bottom", dz_up, dz_dn)
        d_x = self._centred(chi, "east", "west", d["east"], d["west"])
        d_y = self._centred(chi, "north", "south", d["north"], d["south"])
        s = self.face_slopes()
        thk = g["thkcello"]
        at_face = lambda x, dd: 0.5 * (x + neighbour(x, dd, t))

        def across(dd, slope):  # east or north face: kappa A (d_n chi + S d_zeta chi)
            area = torch.minimum(thk, neighbour(thk, dd, t, NAN)) * g[f"edge_length.{dd}"]
            normal = (neighbour(chi, dd, t) - chi) / torch.where(o[dd], d[dd], 1.0)
            flux = kappa * area * (normal + slope * at_face(d_zeta, dd))
            return torch.where(o[dd], flux, 0.0)

        f_east = across("east", s["s_e"])
        f_north = across("north", s["s_n"])
        sx, sy = s["s_ti"], s["s_tj"]
        vertical = (neighbour(chi, "top", t) - chi) / torch.where(o["top"], dz_up, 1.0)
        f_top = torch.where(o["top"], kappa * g["area2d"] * (
            sx * at_face(d_x, "top") + sy * at_face(d_y, "top") + (sx ** 2 + sy ** 2) * vertical),
            0.0)
        inflow = (f_east - neighbour(f_east, "west", t) + f_north - neighbour(f_north, "south", t)
                  + f_top - neighbour(f_top, "bottom", t))
        return torch.where(self.wet, inflow / torch.where(self.wet, g["v3d"], 1.0), 0.0)


def euler(legs: dict, redi: Redi, x: torch.Tensor, dt: float, nsteps: int,
          tripolar: bool) -> torch.Tensor:
    """`nsteps` explicit steps x <- x - dt T x + dt R x, in float64."""
    x = x.to(torch.float64)
    for _ in range(nsteps):
        x = x - dt * reference.apply(legs, x, tripolar) + dt * redi(x)
    return x
