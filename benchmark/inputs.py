"""The right-hand sides of a run, made from ``--seed``.

Each b is ``A x_true`` for a manufactured ``x_true`` drawn as the
reference's ``rand_vect`` draws it (``gmres_perf_test.cpp:39-51``): float
uniforms in [0, 1) from ``std::mt19937(seed)`` through libstdc++'s
``generate_canonical<float, 24>``, stored as float64.  numpy's legacy
``RandomState`` is MT19937 with the same single-integer seeding, and its
``randint(0, 2**32, dtype=uint32)`` returns the raw tempered draws (a CPU
test holds this to ``gmres_tpu_torch.io.rng.rand_vect``).  The j-th x_true
of a run is seeded by ``SeedSequence([seed mod 2**64, j])``, so any
``--seed`` gives distinct 32-bit MT seeds.  ``b = A x_true`` is a plain
CSR product on the host in float64 (``csr_matrix``: scipy's, a row's
products summed in its order, so that a seed gives the same bits every
run)."""

from __future__ import annotations

import numpy as np


def uniform_float_canonical(draws: np.ndarray) -> np.ndarray:
    """libstdc++ ``generate_canonical<float, 24>`` of raw 32-bit draws: the
    quotient in float32, clamped below 1."""
    vals = draws.astype(np.float32) / np.float32(2.0 ** 32)
    return np.where(vals >= np.float32(1.0), np.float32(1.0) - np.float32(2.0 ** -24), vals)


def rand_vect(n: int, seed: int) -> np.ndarray:
    draws = np.random.RandomState(seed).randint(0, 2 ** 32, size=n, dtype=np.uint32)
    return uniform_float_canonical(draws).astype(np.float64)


def mt_seed(seed: int, j: int) -> int:
    """The MT19937 seed of the j-th x_true of a run with ``--seed seed``."""
    return int(np.random.SeedSequence([seed % 2 ** 64, j]).generate_state(1, np.uint32)[0])


def x_trues(n: int, seed: int, count: int) -> list[np.ndarray]:
    return [rand_vect(n, mt_seed(seed, j)) for j in range(count)]


def csr_matrix(row_ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """The operator as a scipy CSR matrix, built once a run: ``A @ x`` is
    A x in float64."""
    import scipy.sparse

    n = row_ptr.shape[0] - 1
    return scipy.sparse.csr_matrix((vals, cols, row_ptr), shape=(n, n))
