"""Utilities of the port (copies of the JAX package's jax-free helpers)."""
