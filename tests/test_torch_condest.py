"""The port's condition-number estimator on the CPU against
``gmres_tpu.solver.condest`` on the same inputs: the same iteration count t
and sigma_max, sigma_min within 1e-9 relative (fp64 throughout; the two
packages sum their dots and products in other orders), the transposes bit
for bit, the operator route, the masked chunks (any read cadence gives the
same bits) and the command line."""

import contextlib
import io

import numpy as np
import pytest
import torch

from gmres_tpu.cli import condest_cli as jax_condest_cli
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.ops.dia import dia_transpose as jax_dia_transpose
from gmres_tpu.ops.dia import from_csr as jax_from_csr
from gmres_tpu.solver import condest as jax_condest
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu_torch.cli import condest_cli
from gmres_tpu_torch.io import synth
from gmres_tpu_torch.ops.dia import DIAMatrix, dia_transpose, from_csr
from gmres_tpu_torch.ops.sell import SELLMatrix
from gmres_tpu_torch.solver import condest as port_condest
from gmres_tpu_torch.sparse import CSRMatrix, csr_from_coo

QUIET = lambda *a: None  # noqa: E731


def _wide_row(pkg_csr_from_coo, n=512, seed=4):
    """A dense first row over a diagonal and one random entry a row: DIA
    refuses (n diagonals) and so does the sliced ELL (its first slice is n
    wide, 30x the entries)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows = np.concatenate([np.zeros(n, np.int64), i, i])
    cols = np.concatenate([i, i, rng.integers(0, n, n)])
    vals = np.concatenate([rng.standard_normal(n), np.full(n, 4.0 + n ** 0.5),
                           rng.standard_normal(n)])
    return pkg_csr_from_coo(rows, cols, vals, n_rows=n)


CASES = {
    "poisson2d_12": (lambda: synth.poisson_2d(12), lambda: jax_synth.poisson_2d(12), 2000),
    "mesh_1024": (lambda: synth.unstructured_mesh(1024, run=3, seed=11),
                  lambda: jax_synth.unstructured_mesh(1024, run=3, seed=11), 100),
    "poisson2d_12_capped": (lambda: synth.poisson_2d(12), lambda: jax_synth.poisson_2d(12), 20),
    "wide_row": (lambda: _wide_row(csr_from_coo), lambda: _wide_row(jax_csr_from_coo), 300),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_condest_matches_gmres_tpu(case):
    port, ref, max_iters = CASES[case]
    cond, smax, smin, t = port_condest.condest(port(), max_iters=max_iters, verbose=QUIET,
                                               device="cpu")
    jcond, jsmax, jsmin, jt = jax_condest.condest(ref(), max_iters=max_iters, verbose=QUIET)
    assert t == jt
    np.testing.assert_allclose([smax, smin, cond], [jsmax, jsmin, jcond], rtol=1e-9)
    if case.endswith("capped"):
        assert t == max_iters + 1


def test_condest_accuracy():
    # tests/test_cli.py:test_condest_accuracy: sigma_max within 2% of the SVD's,
    # the estimate within 25% of the true condition number
    A = synth.poisson_2d(12)
    cond, smax, smin, iters = port_condest.condest(A, max_iters=2000, verbose=QUIET,
                                                   device="cpu")
    s = np.linalg.svd(A.to_scipy().toarray(), compute_uv=False)
    assert abs(smax - s[0]) / s[0] < 0.02
    assert abs(cond - s[0] / s[-1]) / (s[0] / s[-1]) < 0.25


@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_read_cadence_changes_no_bit(chunk):
    # the steps after a stop are masked, so t and sigma_min do not depend on
    # how often the host reads the flags
    A = synth.convection_diffusion_2d(12, beta=2.0)
    want = port_condest.condest(A, max_iters=3000, verbose=QUIET, device="cpu")
    stats = {}
    got = port_condest.condest(A, max_iters=3000, verbose=QUIET, device="cpu", chunk=chunk,
                               stats=stats)
    assert got == want
    assert stats["chunk"] == chunk and stats["lsqr_steps"] >= want[3] - 1


def test_operator_route():
    # banded: DIA for A and A^T (K1 on the card); else the sliced ELL of A
    # and transpose_csr(A) (K5); CSR only when both refuse; all fp64.  The
    # JAX package's double-float SELL route existed for the TPU only.
    for A, kind in ((synth.convection_diffusion_2d(9, dtype=np.float32), DIAMatrix),
                    (synth.unstructured_mesh(2048, run=8), SELLMatrix),
                    (_wide_row(csr_from_coo), CSRMatrix)):
        op, op_t = port_condest.condest_operators(A, torch.device("cpu"))
        assert type(op) is type(op_t) is kind
        assert op.dtype == op_t.dtype == torch.float64
    dia = from_csr(synth.poisson_2d(6))
    op, op_t = port_condest.condest_operators(dia, torch.device("cpu"))
    assert op.offsets == dia.offsets and op_t.offsets == tuple(sorted(-o for o in dia.offsets))


@pytest.mark.parametrize("case", ["convdiff", "poisson_rect", "random"])
def test_transposes_bit_identical(case):
    port, ref = {
        "convdiff": (synth.convection_diffusion_2d(11, beta=3.0),
                     jax_synth.convection_diffusion_2d(11, beta=3.0)),
        "poisson_rect": (synth.poisson_2d(5, 9), jax_synth.poisson_2d(5, 9)),
        "random": (synth.random_sparse(300, row_nnz=5, seed=2),
                   jax_synth.random_sparse(300, row_nnz=5, seed=2)),
    }[case]
    t, jt = port_condest.transpose_csr(port), jax_condest.transpose_csr(ref)
    nnz = jt.nnz
    assert (t.n_rows, t.n_cols, t.nnz) == (jt.n_rows, jt.n_cols, nnz)
    assert np.array_equal(t.row_ptr.numpy(), np.asarray(jt.row_ptr))
    assert np.array_equal(t.col_idx.numpy(), np.asarray(jt.col_idx)[:nnz])
    assert t.vals.numpy().tobytes() == np.asarray(jt.vals)[:nnz].tobytes()
    np.testing.assert_array_equal(t.to_scipy().toarray(), port.to_scipy().toarray().T)
    d, jd = from_csr(port), jax_from_csr(ref)
    if jd is None:
        assert d is None
        return
    dt, jdt = dia_transpose(d), jax_dia_transpose(jd)
    assert dt.offsets == jdt.offsets and (dt.n_rows, dt.n_cols, dt.nnz) == \
        (jdt.n_rows, jdt.n_cols, jdt.nnz)
    assert dt.data.numpy().tobytes() == np.asarray(jdt.data).tobytes()
    np.testing.assert_array_equal(dt.to_dense(), d.to_dense().T)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_condest_cli_matches_gmres_tpu():
    argv = ["--device", "cpu", "--synth", "poisson2d:12", "--max-iters", "2000"]
    (rj, oj), (rp, op) = _run(jax_condest_cli.main, argv), _run(condest_cli.main, argv)
    assert rj == rp == 0
    lj, lp = oj.splitlines(), op.splitlines()
    assert [ln.split(" = ")[0] for ln in lp] == [ln.split(" = ")[0] for ln in lj] == \
        ["sigma_max", "99 iterations total", "Computed cond(A)"]
    assert lp == lj  # %g: six digits, the same in both
    for main in (jax_condest_cli.main, condest_cli.main):
        assert _run(main, ["--device", "cpu"]) == (1, "No value suplied for A\n")


def test_condest_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the contract is about machines without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_condest.condest(synth.poisson_2d(4), verbose=QUIET)
    for argv in (["--synth", "poisson2d:4"], ["--synth", "poisson2d:4", "--gpu"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            _run(condest_cli.main, argv)
