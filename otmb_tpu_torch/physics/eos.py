"""Built-in seawater equation of state: the polyTEOS10-bsq polynomial.

Counterpart of `otmb_tpu.physics.eos`, with its own copy of the 55
coefficients of

    Roquet, F., G. Madec, T. J. McDougall, P. M. Barker (2015),
    "Accurate polynomial expressions for the density and specific
    volume of seawater using the TEOS-10 standard", Ocean Modelling 90.

(the "polyTEOS10-bsq" fit, the one adopted by NEMO): in-situ density as a
degree-(6,6,3) polynomial in reduced Absolute Salinity, Conservative
Temperature and depth, rho = r0(z) + r(SA, CT, z). The Horner chains run
in the JAX package's order, so the two agree to a few ulps in float64;
thermal expansion and haline contraction come out of `torch.autograd`.

Conventions: SA in g/kg, CT in degrees Celsius, depth in metres, positive
down (`GridMetrics.z3d`). Outside the fit's envelope (SA in [0, 42] g/kg,
CT in [-2, 40] C, depth in [0, 10989] m) the polynomial extrapolates
smoothly but loses accuracy.

Arguments are tensors or numbers; numbers take the dtype and device of
the tensor arguments, and at least one argument must be a tensor. The
result lies on the device of the tensors.
"""

from __future__ import annotations

import torch

from ..utils.tracing import traced

# Reduction constants (Roquet et al. 2015, Appendix A.2).
_SAU = 40.0 * 35.16504 / 35.0
_CTU = 40.0
_ZU = 1.0e4
_DELTAS = 32.0

# Vertical reference-profile coefficients r0(z).
_R00 = 4.6494977072e01
_R01 = -5.2099962525e00
_R02 = 2.2601900708e-01
_R03 = 6.4326772569e-02
_R04 = 1.5616995503e-02
_R05 = -1.7243708991e-03

# 55-term coefficients R_ijk (i: ss power, j: tt power, k: zz power).
_R000 = 8.0189615746e02
_R100 = 8.6672408165e02
_R200 = -1.7864682637e03
_R300 = 2.0375295546e03
_R400 = -1.2849161071e03
_R500 = 4.3227585684e02
_R600 = -6.0579916612e01
_R010 = 2.6010145068e01
_R110 = -6.5281885265e01
_R210 = 8.1770425108e01
_R310 = -5.6888046321e01
_R410 = 1.7681814114e01
_R510 = -1.9193502195e00
_R020 = -3.7074170417e01
_R120 = 6.1548258127e01
_R220 = -6.0362551501e01
_R320 = 2.9130021253e01
_R420 = -5.4723692739e00
_R030 = 2.1661789529e01
_R130 = -3.3449108469e01
_R230 = 1.9717078466e01
_R330 = -3.1742946532e00
_R040 = -8.3627885467e00
_R140 = 1.1311538584e01
_R240 = -5.3563304045e00
_R050 = 5.4048723791e-01
_R150 = 4.8169980163e-01
_R060 = -1.9083568888e-01
_R001 = 1.9681925209e01
_R101 = -4.2549998214e01
_R201 = 5.0774768218e01
_R301 = -3.0938076334e01
_R401 = 6.6051753097e00
_R011 = -1.3336301113e01
_R111 = -4.4870114575e00
_R211 = 5.0042598061e00
_R311 = -6.5399043664e-01
_R021 = 6.7080479603e00
_R121 = 3.5063081279e00
_R221 = -1.8795372996e00
_R031 = -2.4649669534e00
_R131 = -5.5077101279e-01
_R041 = 5.5927935970e-01
_R002 = 2.0660924175e00
_R102 = -4.9527603989e00
_R202 = 2.5019633244e00
_R012 = 2.0564311499e00
_R112 = -2.1311365518e-01
_R022 = -1.2419983026e00
_R003 = -2.3342758797e-02
_R103 = -1.8507636718e-02
_R013 = 3.7969820455e-01


def _tensors(*xs):
    """The arguments as tensors: numbers take the dtype and device of the
    first tensor argument."""
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if ref is None:
        raise TypeError("equation of state: pass at least one tensor argument")
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.as_tensor(x, dtype=ref.dtype, device=ref.device) for x in xs)


@traced
def rho_teos10(sa, ct, depth):
    """In-situ Boussinesq density rho(SA, CT, depth) [kg/m^3]
    (polyTEOS10-bsq, Roquet et al. 2015 eq. 8/Appendix A.2): the `eos`
    argument of `models.redigm.potential_density_slopes`. `sa` in g/kg,
    `ct` in degrees C, `depth` in metres positive down; broadcastable."""
    sa, ct, depth = _tensors(sa, ct, depth)
    ss = torch.sqrt((sa + _DELTAS) / _SAU)
    tt = ct / _CTU
    zz = depth / _ZU  # paper's zz = -z/Zu with z negative down

    r0 = (((((_R05 * zz + _R04) * zz + _R03) * zz + _R02) * zz + _R01)
          * zz + _R00) * zz

    rz3 = _R013 * tt + _R103 * ss + _R003
    rz2 = ((_R022 * tt + _R112 * ss + _R012) * tt
           + (_R202 * ss + _R102) * ss + _R002)
    rz1 = ((((_R041 * tt + _R131 * ss + _R031) * tt
             + (_R221 * ss + _R121) * ss + _R021) * tt
            + ((_R311 * ss + _R211) * ss + _R111) * ss + _R011) * tt
           + (((_R401 * ss + _R301) * ss + _R201) * ss + _R101) * ss
           + _R001)
    rz0 = ((((((_R060 * tt + _R150 * ss + _R050) * tt
               + (_R240 * ss + _R140) * ss + _R040) * tt
              + ((_R330 * ss + _R230) * ss + _R130) * ss + _R030) * tt
             + (((_R420 * ss + _R320) * ss + _R220) * ss + _R120) * ss
             + _R020) * tt
            + ((((_R510 * ss + _R410) * ss + _R310) * ss + _R210) * ss
               + _R110) * ss + _R010) * tt
           + (((((_R600 * ss + _R500) * ss + _R400) * ss + _R300) * ss
               + _R200) * ss + _R100) * ss + _R000)

    return ((rz3 * zz + rz2) * zz + rz1) * zz + rz0 + r0


def sigma0_teos10(sa, ct):
    """Surface-referenced potential density anomaly sigma_0 [kg/m^3]:
    rho(SA, CT, 0) - 1000."""
    sa, ct = _tensors(sa, ct)
    return rho_teos10(sa, ct, 0.0) - 1000.0


def linear_eos(rho0: float = 1035.0, alpha: float = 2.0e-4,
               beta: float = 7.6e-4, ct0: float = 10.0, sa0: float = 35.0):
    """A linear EOS factory: rho = rho0 * (1 - alpha (CT-ct0)
    + beta (SA-sa0)), depth-independent. Returns an `eos(sa, ct, depth)`
    callable with the signature of `rho_teos10`."""

    def eos(sa, ct, depth):
        del depth
        sa, ct = _tensors(sa, ct)
        return rho0 * (1.0 - alpha * (ct - ct0) + beta * (sa - sa0))

    return eos
