"""The benchmark's frozen copies of the operator generator and of
``rand_vect`` against the program's, entry for entry."""

import numpy as np
import pytest

from benchmark import inputs
from benchmark.operators import generator
from gmres_tpu_torch.io.rng import rand_vect as port_rand_vect
from gmres_tpu_torch.io.synth import convection_diffusion_2d


@pytest.mark.parametrize("nx,beta", [(2, 2.0), (7, 2.0), (16, 20.0), (33, 2.0)])
def test_convection_diffusion_equals_the_port(nx, beta):
    row_ptr, cols, vals = generator("convection_diffusion_2d").build(nx=nx, beta=beta)
    A = convection_diffusion_2d(nx, beta=beta)
    rp, ci, v = A.numpy_arrays()
    assert np.array_equal(row_ptr, rp)
    assert np.array_equal(cols, ci[: rp[-1]])
    assert np.array_equal(vals, v[: rp[-1]])
    assert len(np.unique(cols - np.repeat(np.arange(nx * nx), np.diff(rp)))) == \
        generator("convection_diffusion_2d").diagonals(nx=nx, beta=beta)


def test_full_size_counts():
    """The configurations' n and nnz are what the generator makes (counted
    without building the 4M operator: 5n - 4nx)."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    for f in sorted((root / "benchmark" / "configs").glob("*.json")):
        conf = json.loads(f.read_text())
        nx = conf["operator"]["nx"]
        assert conf["n"] == nx * nx
        assert conf["nnz"] == 5 * nx * nx - 4 * nx
    row_ptr, _, _ = generator("convection_diffusion_2d").build(nx=40, beta=2.0)
    assert row_ptr[-1] == 5 * 40 * 40 - 4 * 40


@pytest.mark.parametrize("seed", [0, 7, 42, 2 ** 31 + 11, 2 ** 32 - 1])
@pytest.mark.parametrize("n", [1, 623, 624, 625, 5000])
def test_rand_vect_equals_the_port(seed, n):
    assert np.array_equal(inputs.rand_vect(n, seed), port_rand_vect(n, seed))


def test_seeds_of_a_run():
    seeds = {inputs.mt_seed(s, j) for s in (0, 1, 2 ** 31 + 5, 2 ** 40) for j in range(8)}
    assert len(seeds) == 32
    assert all(0 <= s < 2 ** 32 for s in seeds)
    a = inputs.x_trues(100, 2 ** 31 + 5, 3)
    b = inputs.x_trues(100, 2 ** 31 + 5, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])


def test_csr_matvec_by_hand():
    # A = [[2, 1, 0], [0, 0, 0], [-1, 0, 4]]: an empty row among rows of different lengths
    row_ptr = np.array([0, 2, 2, 4])
    cols = np.array([0, 1, 0, 2])
    vals = np.array([2.0, 1.0, -1.0, 4.0])
    y = inputs.csr_matrix(row_ptr, cols, vals) @ np.array([1.0, 2.0, 3.0])
    assert y.dtype == np.float64 and y.tolist() == [4.0, 0.0, 11.0]
