"""Preconditioners: identity and Jacobi."""
