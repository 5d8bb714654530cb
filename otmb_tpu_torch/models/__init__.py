"""Operator front door and solvers."""
