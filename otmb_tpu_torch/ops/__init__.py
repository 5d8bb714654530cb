"""Stencil operators: fluxes, assembly, apply, and the K1/K2/K4 kernels."""
