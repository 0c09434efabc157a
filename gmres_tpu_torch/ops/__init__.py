"""Operators and the kernels behind them."""
