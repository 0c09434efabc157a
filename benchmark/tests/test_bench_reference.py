"""The plain reference's product and backward error against cases worked
by hand."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import Reference


def _ref():
    # A = [[2, 1, 0], [0, 3, 0], [-1, 0, 4]], rows of different lengths
    row_ptr = np.array([0, 2, 3, 5])
    cols = np.array([0, 1, 1, 0, 2])
    vals = np.array([2.0, 1.0, 3.0, -1.0, 4.0])
    return Reference(row_ptr, cols, vals, "cpu")


def test_matvec():
    y = _ref().matvec(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    assert y.tolist() == [4.0, 6.0, 11.0]


def test_backward_error_by_hand():
    ref = _ref()
    b = torch.tensor([4.0, 6.0, 11.0], dtype=torch.float64)
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert ref.backward_error(b, x) == 0.0
    # x off by 0.5 in its last entry: r = (0, 0, -2)
    x2 = torch.tensor([1.0, 2.0, 3.5], dtype=torch.float64)
    a_fro = math.sqrt(4 + 1 + 9 + 1 + 16)
    expect = 2.0 / (math.sqrt(16 + 36 + 121) + a_fro * math.sqrt(1 + 4 + 12.25))
    assert ref.backward_error(b, x2) == pytest.approx(expect, rel=1e-15)


def test_blocks_of_rows(monkeypatch):
    import benchmark.reference as r

    rng = np.random.default_rng(3)
    n = 1000
    dense = np.where(rng.random((n, n)) < 0.01, rng.standard_normal((n, n)), 0.0)
    np.fill_diagonal(dense, 5.0)
    rows, cols = np.nonzero(dense)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    monkeypatch.setattr(r, "BLOCK_ROWS", 97)
    ref = Reference(row_ptr, cols, dense[rows, cols], "cpu")
    x = rng.standard_normal(n)
    np.testing.assert_allclose(ref.matvec(torch.from_numpy(x)).numpy(), dense @ x, rtol=1e-13,
                               atol=1e-13)
