"""Seawater equation of state (TEOS-10 polynomial and a linear EOS)."""
