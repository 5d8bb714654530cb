"""Seawater equation of state (TEOS-10 polynomial and a linear EOS)."""

from .eos import linear_eos, rho_teos10, sigma0_teos10

__all__ = ["linear_eos", "rho_teos10", "sigma0_teos10"]
