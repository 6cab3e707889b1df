"""Quadrature rules read from the JAX package's committed table."""
