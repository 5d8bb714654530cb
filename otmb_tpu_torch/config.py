"""Physical constants and default parameters.

The same values as `otmb_tpu.config`: the reference package's kappa
defaults (matrixbuilding.jl:128-138), the rho = 1035 kg/m^3 convention,
the GM parameters (RediGM.jl:46,59-60) and the haversine Earth radius of
Distances.jl (6,371,000 m).
"""

from __future__ import annotations

import dataclasses

# Earth radius used by all haversine distances (m).
EARTH_RADIUS = 6_371_000.0

# Reference density convention (kg/m^3), Chamberlain et al. (2019).
RHO_DEFAULT = 1035.0

# Diffusivities (m^2/s) — reference matrixbuilding.jl:130-132.
KAPPA_H_DEFAULT = 500.0
KAPPA_VML_DEFAULT = 0.1
KAPPA_VDEEP_DEFAULT = 1.0e-5

# Gent-McWilliams parameters — reference RediGM.jl:46,59-60.
KAPPA_GM_DEFAULT = 600.0
MAXSLOPE_DEFAULT = 0.01
SLOPE_TAPER_SC = 0.004
SLOPE_TAPER_SD = 0.001


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Bundle of the physics defaults for `transportmatrix`."""

    rho: float = RHO_DEFAULT
    kappa_h: float = KAPPA_H_DEFAULT
    kappa_vml: float = KAPPA_VML_DEFAULT
    kappa_vdeep: float = KAPPA_VDEEP_DEFAULT
    upwind: bool = True
