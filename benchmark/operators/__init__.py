"""Operator generators, one module a generator, found by the name in a
configuration's ``operator.generator``.  Each module has ``build(**params)``
returning the operator as host CSR arrays ``(row_ptr, cols, vals)`` (int64,
int64, float64; rows in order, columns sorted within a row) and
``diagonals(**params)``, the number of distinct diagonals the pattern has
(the D of the DIA byte rules)."""

from __future__ import annotations

import importlib


def generator(name: str):
    return importlib.import_module(f"benchmark.operators.{name}")
