"""Numpy-only helpers (own copies: importing the JAX ones imports jax)."""
