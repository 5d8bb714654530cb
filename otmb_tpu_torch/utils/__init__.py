"""Synthetic data, sparse export and conversion from the JAX package."""
