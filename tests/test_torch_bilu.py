"""The block-Jacobi ILU (``precond="bilu_jacobi"``, ``gmres_tpu_torch/
precond/bilu.py``) against the JAX package's ``gmres_tpu/precond/bilu.py``.

Held to:
- the factors of ``build_bilu_jacobi``: the JAX package's form (DIA or
  CSR) and every array equal, value for value, in fp32 and fp64; a
  per-rank build (``owned={rank}``, the metadata through an exchange over
  threads) equal to the global build's pieces;
- the routes of a rank's factors (a decision of the H100 port, stated
  here): DIA bands sweep on K1 (``DIAMatrix``; bf16 bands in plain torch),
  CSR triangles pack into the single card's sliced ELL and sweep on K5
  (``SELLMatrix``; bf16 stays CSR), each ``block_local`` (no collective);
- solves on four gloo ranks (one spawn, the CPU, the kernels' plain
  versions) against the JAX package's ``solve_distributed`` on a
  four-device CPU mesh: restarts within one (equal in ``baseline`` and
  ``df64``), x within 1e-6 of its x (1e-10 in fp64 cycles; the bf16 tier,
  whose tol is 1e-6: its backward error within tol, x within 1e-4);
- the dense oracle ``tests/oracle_gmres.py``: on a matrix without
  couplings between the ranks' blocks the block-Jacobi ILU is the global
  ILU(0), so the oracle's ILU-Jacobi(3) holds it: restarts within one, x
  within 1e-5;
- ``multihost=True``: the same bits as the default, from a quarter of the
  factor bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.parallel.dist_gmres import AXIS
from gmres_tpu.parallel.dist_gmres import solve_distributed as jax_solve_distributed
from gmres_tpu.precond import bilu as jax_bilu
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.ops.sell import SELLMatrix
from gmres_tpu_torch.parallel import launch
from gmres_tpu_torch.precond import bilu
from gmres_tpu_torch.sparse import CSRMatrix

import gmres_tpu.native as jax_native
import torch_rank_helpers
from oracle_gmres import oracle_solve
from test_torch_bf16_ilu import jax_bf16_ilu  # noqa: F401  (autouse: bf16's np.finfo)

P = 4


@pytest.fixture(autouse=True)
def jax_numpy_ilu(monkeypatch):
    # the JAX package's numpy ILU(0), which the port's is held to bit for bit,
    # even where another test of this process has loaded its native library
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_lib_failed", True)


def _banded():
    return jax_synth.convection_diffusion_2d(12, beta=1.0)


def _scattered():
    return jax_synth.unstructured_mesh(1024, run=3, seed=3)


def _block_diagonal():
    """convdiff(12) without the entries that couple the four ranks' row
    blocks: its block-Jacobi ILU is its global ILU(0)."""
    A = jax_synth.convection_diffusion_2d(12, beta=1.0)
    rp = np.asarray(A.row_ptr)
    ci = np.asarray(A.col_idx)[:A.nnz]
    v = np.asarray(A.vals)[:A.nnz]
    rows = np.repeat(np.arange(A.n_rows), np.diff(rp))
    r = -(-A.n_rows // P)
    keep = rows // r == ci // r
    return jax_csr_from_coo(rows[keep], ci[keep], v[keep], n_rows=A.n_rows)


def _precision(pkg, tier):
    if tier == "mixed-cb":
        return dataclasses.replace(pkg.PrecisionSpec.from_mode("mixed"), basis="bfloat16")
    if tier == "bf16":
        return pkg.PrecisionSpec("float64", "bfloat16", "bfloat16")
    return pkg.PrecisionSpec.from_mode(tier)


COMMON = dict(orth="cgsr", precond="bilu_jacobi", jacobi_steps=3, restart_length=12,
              tol=1e-9, max_restarts=100)
# label -> (matrix, tier, config)
CASES = {
    "dia-mixed": (_banded, "mixed", COMMON),
    "dia-baseline": (_banded, "baseline", COMMON),
    "dia-df64": (_banded, "df64", COMMON),
    "dia-mixed-cb": (_banded, "mixed-cb", COMMON),
    "dia-bf16": (_banded, "bf16", dict(COMMON, tol=1e-6, restart_length=20)),
    "dia-icwy": (_banded, "mixed", dict(COMMON, orth="mgs")),
    "csr-mixed": (_scattered, "mixed", COMMON),
    "csr-baseline": (_scattered, "baseline", COMMON),
    "allgather-mixed": (_banded, "mixed", dict(COMMON, auto_format=False)),
    "block-diagonal": (_block_diagonal, "mixed", COMMON),
}


def _port_csr(A):
    return csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)


def _configs(tier, kw):
    return (gmres_tpu.GmresConfig(precision=_precision(gmres_tpu, tier), **kw),
            gmres_tpu_torch.GmresConfig(precision=_precision(gmres_tpu_torch, tier), **kw))


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    return x_true, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


@pytest.fixture(scope="module")
def port_results():
    """Every case on one spawn of P gloo ranks (and dia-mixed again with
    ``multihost=True``): label -> rank 0's result, every rank checked to
    hold the same."""
    cases = []
    for label, (make, tier, kw) in CASES.items():
        A = make()
        cases.append(dict(label=label, A=_port_csr(A), b=_problem(A)[1],
                          cfg=_configs(tier, kw)[1]))
    cases.append(dict(cases[0], label="dia-mixed/multihost", multihost=True))
    per_rank = launch.spawn(torch_rank_helpers.run_cases, P, args=(cases, "cpu"))
    out = {}
    for i, case in enumerate(cases):
        ranks = [r[i] for r in per_rank]
        for other in ranks[1:]:
            assert (other["restarts"], other["total_iters"]) == \
                (ranks[0]["restarts"], ranks[0]["total_iters"])
            assert np.array_equal(other["x"], ranks[0]["x"])
        out[case["label"]] = ranks[0]
    return out


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("label", list(CASES))
def test_matches_jax_distributed(label, port_results):
    make, tier, kw = CASES[label]
    A = make()
    x_true, b = _problem(A)
    got = port_results[label]
    ref = jax_solve_distributed(A, b, _configs(tier, kw)[0],
                                mesh=Mesh(np.array(jax.devices()[:P]), (AXIS,)))
    assert ref.converged and got["converged"]
    assert abs(got["restarts"] - ref.restarts) <= 1
    fp64 = tier in ("baseline", "df64")
    if fp64:
        assert (got["restarts"], got["total_iters"]) == (ref.restarts, ref.total_iters)
    tol = 1e-10 if fp64 else 1e-4 if tier == "bf16" else 1e-6
    assert _rel(got["x"], np.asarray(ref.x)) <= tol
    if tier == "bf16":
        x = got["x"]
        backward = np.linalg.norm(b - A.to_scipy() @ x) / (
            np.linalg.norm(b) + np.linalg.norm(np.asarray(A.vals)) * np.linalg.norm(x))
        assert backward <= kw["tol"]


def test_block_diagonal_matches_the_oracle(port_results):
    A = _block_diagonal()
    _, b = _problem(A)
    got = port_results["block-diagonal"]
    orc = oracle_solve(A.to_scipy().toarray(), b, tol=COMMON["tol"],
                       rlen=COMMON["restart_length"], max_restarts=COMMON["max_restarts"],
                       orth="cgsr", mode="mixed", ilu_jacobi_steps=3)
    assert orc.converged and abs(got["restarts"] - orc.restarts) <= 1
    assert _rel(got["x"], orc.x) <= 1e-5


def test_multihost_build_holds_its_own_block(port_results):
    got, full = port_results["dia-mixed/multihost"], port_results["dia-mixed"]
    assert (got["restarts"], got["total_iters"]) == (full["restarts"], full["total_iters"])
    assert np.array_equal(got["x"], full["x"])
    assert got["partition_local_bytes"] * P == full["partition_local_bytes"]


def _port_arrays(M):
    return {f.name: getattr(M, f.name) for f in dataclasses.fields(M)
            if isinstance(getattr(M, f.name), np.ndarray)}


@pytest.mark.parametrize("make,form", [(_banded, "BlockILUDia"), (_scattered, "BlockILUCSR")])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_factors_match_jax(make, form, dtype):
    A = make()
    r = -(-A.n_rows // P)
    ref = jax_bilu.build_bilu_jacobi(A, P, r, np.dtype(dtype), 3)
    got = bilu.build_bilu_jacobi(_port_csr(A), P, r, getattr(torch, dtype), 3)
    assert type(ref).__name__ == type(got).__name__ == form
    arrays = _port_arrays(got)
    assert arrays
    for name, a in arrays.items():
        want = np.asarray(getattr(ref, name))
        assert a.shape == want.shape, name
        np.testing.assert_array_equal(a, want.astype(a.dtype), err_msg=name)
    if form == "BlockILUDia":
        assert (got.offsets_l, got.offsets_u) == (ref.offsets_l, ref.offsets_u)


@pytest.mark.parametrize("make", [_banded, _scattered])
def test_per_rank_build_matches_global(make):
    A = _port_csr(make())
    r = -(-A.n_rows // P)
    full = bilu.build_bilu_jacobi(A, P, r, torch.float32, 3)
    pieces = torch_rank_helpers.run_threaded(
        lambda rank, ex: bilu.build_bilu_jacobi(A, P, r, torch.float32, 3, owned={rank},
                                                exchange=ex), P)
    for rank, M in enumerate(pieces):
        assert type(M) is type(full)
        for name, a in _port_arrays(full).items():
            stack = getattr(M, name)
            assert set(stack.pieces) == {rank} and stack.shape == a.shape
            np.testing.assert_array_equal(stack[rank], a[rank], err_msg=name)


@pytest.mark.parametrize("make,dtype,route", [
    (_banded, torch.float32, DIAMatrix), (_banded, torch.bfloat16, DIAMatrix),
    (_scattered, torch.float32, SELLMatrix), (_scattered, torch.float64, SELLMatrix),
    (_scattered, torch.bfloat16, CSRMatrix)])
def test_rank_factor_routes(make, dtype, route):
    # DIA bands sweep on K1 (bf16: plain torch), CSR triangles on the single
    # card's sliced ELL, K5 (bf16 stays CSR); no collective in the sweeps
    A = _port_csr(make())
    r = -(-A.n_rows // P)
    M = bilu.build_bilu_jacobi(A, P, r, dtype, 3)
    for rank in range(P):
        loc = bilu.localize_bilu(M, rank)
        assert loc.block_local and loc.steps == 3
        assert type(loc.lower) is route and type(loc.upper) is route
        assert loc.lower.dtype == loc.upper.dtype == loc.inv_diag.dtype == dtype
        assert loc.lower.n_rows == loc.inv_diag.shape[0] == r
