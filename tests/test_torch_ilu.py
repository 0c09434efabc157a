"""Slice 3 of the port: the ILU(0) preconditioners, held to ``gmres_tpu`` on
the CPU with the same seeded numpy inputs.

- The host helper (``csrc/ilu_host.cpp``) and the numpy twin factor bit for
  bit as ``gmres_tpu.precond.ilu0.ilu0_factorize_numpy``; levels, the
  triangle split and the level-scheduled pack are identical arrays.
- Applies: ILU-Jacobi on CSR and DIA factors within 1e-13 (fp64) / 1e-6
  (fp32) of the JAX apply; K6's plain versions within 1e-6 of the JAX
  trisolve kernels in interpret mode (fp32; the TPU kernel has no fp64),
  within 1e-13 in fp64 of the JAX package's fp64 exact route (plain sweeps),
  and both within those bounds of a scipy substitution.  Relative to the
  largest |value|: the two sum in other orders.
- Whole-slice histories equal ``gmres_tpu.solve``'s (restarts and
  iterations exactly; per-cycle values within the ``TOL`` table of
  ``tests/test_torch_solver.py``, except where stated at the test), and the
  dense oracle's within one restart.

The JAX package's ILU build functions try its native library first, which compiles
``csrc/libgmres_native.so`` in place; under xdist a concurrent load of the
half-written file skips ``tests/test_sell_native.py``.  Every test here
therefore makes the JAX package take its numpy path (``_lib_failed``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import gmres_tpu
import gmres_tpu.native as jax_native
import gmres_tpu_torch
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.ops.pallas.trisolve_kernel import ilu_trisolve_fused as jax_fused
from gmres_tpu.ops.pallas.trisolve_kernel import ilu_trisolve_segmented as jax_segmented
from gmres_tpu.precond import build as jax_build
from gmres_tpu.precond import ilu0 as jax_ilu0
from gmres_tpu.precond import level_ilu as jax_level
from gmres_tpu.precond.apply import apply_preconditioner as jax_apply
from gmres_tpu.ops.reorder import permute_symmetric
from gmres_tpu.solver.gmres import _pad_prec
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu.sparse import csr_from_dense as jax_csr_from_dense
from gmres_tpu_torch import convert
from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk
from gmres_tpu_torch.io.synth import convection_diffusion_2d
from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.ops.sell import SELLMatrix
from gmres_tpu_torch.precond import build as port_build
from gmres_tpu_torch.precond import ilu0 as port_ilu0
from gmres_tpu_torch.precond import level_ilu as port_level
from gmres_tpu_torch.precond.apply import apply_preconditioner

from oracle_gmres import oracle_solve
from test_torch_solver import FLOOR, TOL, _agree, _configs, _dense, _port_csr, _problem

RTOL = {np.float32: 1e-6, np.float64: 1e-13}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
DTYPES = pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])


@pytest.fixture(autouse=True)
def jax_ilu_on_numpy(monkeypatch):
    if jax_native._lib is None:
        monkeypatch.setattr(jax_native, "_lib_failed", True)


def _arrays(A):
    rp = np.asarray(A.row_ptr).astype(np.int64)
    return rp, np.asarray(A.col_idx)[: rp[-1]], np.asarray(A.vals)[: rp[-1]]


def _boost_matrix():
    # pivot (1, 1): 2 - (1/2)*4 = 0 -> boosted (tests/test_precond.py:66)
    return jax_csr_from_dense(np.array([[2.0, 4.0, 0.0], [1.0, 2.0, 1.0], [0.0, 1.0, 3.0]]))


def _matrix(case):
    if case == "convdiff":
        return jax_synth.convection_diffusion_2d(12, beta=2.0)
    if case == "poisson":
        return jax_synth.poisson_2d(9, 14)
    if case == "random":
        return jax_synth.random_sparse(200, row_nnz=5, seed=3)
    return _boost_matrix()


def _close(got, want, dt, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(got - want).max() <= RTOL[dt] * scale


def _substitution(M_jax_csr, w):
    """Exact L then U substitution with scipy on fp64 copies of the
    factors of a JAX ILUJacobiPrec with CSR triangles."""
    n = w.shape[0]
    L = sp.identity(n, format="csr") + M_jax_csr.lower.to_scipy().astype(np.float64)
    U = M_jax_csr.upper.to_scipy().astype(np.float64).tocsr()
    y = spla.spsolve_triangular(L.tocsr(), np.asarray(w, np.float64), lower=True)
    return spla.spsolve_triangular(U, y, lower=False)


# ---------------------------------------------------------------- host setup


@DTYPES
@pytest.mark.parametrize("case", ["convdiff", "poisson", "random", "boost"])
def test_ilu0_bit_identical(case, dt):
    rp, ci, v = _arrays(_matrix(case))
    want, want_diag = jax_ilu0.ilu0_factorize_numpy(rp, ci, v, dt)
    bits = np.uint32 if dt == np.float32 else np.uint64
    for fn in (port_ilu0.ilu0_factorize, port_ilu0.ilu0_factorize_numpy):
        got, diag = fn(rp, ci, v, TDT[dt])
        got = got.numpy()
        assert got.dtype == want.dtype and np.array_equal(diag, want_diag)
        assert np.array_equal(got.view(bits), want.view(bits))
    if case == "boost":
        assert want[want_diag[1]] == np.finfo(dt).eps * 6.0


@pytest.mark.parametrize("case", ["convdiff", "poisson", "random"])
def test_levels_identical(case):
    rp, ci, _ = _arrays(_matrix(case))
    diag = jax_ilu0.diag_positions(rp, ci)
    assert np.array_equal(port_ilu0.diag_positions(rp, ci), diag)
    assert port_ilu0.triangular_level_counts(rp, ci, diag) == \
        jax_ilu0.triangular_level_counts(rp, ci, diag)
    for got, want in zip(port_ilu0.triangular_levels(rp, ci, diag),
                         jax_level.triangular_levels(rp, ci, diag)):
        assert np.array_equal(got, want)


@DTYPES
def test_split_triangles_identical(dt):
    A = jax_synth.convection_diffusion_2d(10, beta=2.0)
    want = jax_build.build_ilu_jacobi(A, dt, steps=3)
    got = port_build.build_ilu_jacobi(_port_csr(A), TDT[dt], 3)
    assert got.steps == 3
    for g, w in ((got.lower, want.lower), (got.upper, want.upper)):
        assert np.array_equal(g.row_ptr.numpy(), np.asarray(w.row_ptr))
        assert np.array_equal(g.col_idx.numpy(), np.asarray(w.col_idx)[: w.nnz])
        assert np.array_equal(g.vals.numpy(), np.asarray(w.vals)[: w.nnz])
    assert np.array_equal(got.inv_diag.numpy(), np.asarray(want.inv_diag))


def test_ilu_trisolve_host_matches_substitution():
    A = jax_synth.random_sparse(300, row_nnz=5, seed=5)
    rp, ci, v = _arrays(A)
    fvals, diag = port_ilu0.ilu0_factorize(rp, ci, v)
    fvals = fvals.numpy()
    w = np.random.default_rng(1).standard_normal(A.n_rows)
    want = _substitution(jax_build.build_ilu_jacobi(A, np.float64, steps=1), w)
    _close(port_ilu0.ilu_trisolve_host(rp, ci, fvals, diag, w), want, np.float64)


# ------------------------------------------------------------------ applies


@DTYPES
@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_ilu_jacobi_apply_matches_jax(fmt, dt):
    A = jax_synth.convection_diffusion_2d(16, beta=2.0)
    Mj = jax_build.build_ilu_jacobi(A, dt, steps=3)
    M = port_build.build_ilu_jacobi(_port_csr(A), TDT[dt], 3)
    if fmt == "dia":
        Mj = jax_build.optimize_precond_format(Mj)
        M = port_build.optimize_precond_format(M)
        assert isinstance(M.lower, DIAMatrix) and M.lower.offsets == Mj.lower.offsets
    w = np.random.default_rng(2).standard_normal(A.n_rows).astype(dt)
    want = np.asarray(jax_apply(Mj, jnp.asarray(w)))
    got = apply_preconditioner(M, torch.from_numpy(w))
    assert got.dtype == TDT[dt]
    _close(got.numpy(), want, dt)


@DTYPES
def test_sell_packed_factors_apply_as_csr(dt):
    # an unstructured factor DIA refuses packs into sliced ELL at every size
    A = _port_csr(jax_synth.unstructured_mesh(1000, run=3))
    M = port_build.build_ilu_jacobi(A, TDT[dt], 3)
    assert port_build.optimize_precond_format(M) is M
    Ms = port_build.sell_pack_factors(M)
    assert isinstance(Ms.lower, SELLMatrix) and isinstance(Ms.upper, SELLMatrix)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(A.n_rows).astype(dt))
    _close(apply_preconditioner(Ms, w).numpy(), apply_preconditioner(M, w).numpy(), dt)


def _jax_exact(A, dt, budget=None, monkeypatch=None):
    if budget is not None:
        monkeypatch.setattr(jax_build, "_TRISOLVE_VMEM_BYTES", budget)
    return jax_build.build_ilu_exact(A, dt)


def _port_state(Mj):
    return convert.exact_ilu_from_numpy(
        np.asarray(Mj.lower_bands), np.asarray(Mj.upper_bands), np.asarray(Mj.inv_diag),
        Mj.offs_l, Mj.offs_u, Mj.steps_l, Mj.steps_u, Mj.seg, Mj.steps_l_segs,
        Mj.steps_u_segs)


@pytest.mark.parametrize("nx", [7, 16, 32])
def test_fused_plain_matches_jax_kernel(nx):
    A = jax_synth.convection_diffusion_2d(nx, beta=2.0)
    Mj = jax_build.build_ilu_exact(A, np.float32)
    assert isinstance(Mj, jax_build.ExactILUDIAPrec) and Mj.seg == 0
    w = np.random.default_rng(nx).standard_normal(A.n_rows).astype(np.float32)
    want = np.asarray(jax_fused(Mj.lower_bands, Mj.upper_bands, Mj.inv_diag, jnp.asarray(w),
                                Mj.offs_l, Mj.offs_u, Mj.steps_l, Mj.steps_u))
    # the JAX state (lane-padded bands) through the port's plain version
    got = tk.ilu_trisolve_fused_plain(*_args(_port_state(Mj), w), Mj.steps_l, Mj.steps_u)
    _close(got.numpy(), want, np.float32)
    # the port's own build: the same offsets, level counts and bands
    M = port_build.build_ilu_exact(_port_csr(A), torch.float32)
    assert isinstance(M, port_build.ExactILUDIAPrec) and M.seg == 0
    assert (M.offs_l, M.offs_u, M.steps_l, M.steps_u) == \
        (Mj.offs_l, Mj.offs_u, Mj.steps_l, Mj.steps_u)
    assert np.array_equal(M.lower_bands.numpy(),
                          np.asarray(Mj.lower_bands)[: len(Mj.offs_l), : A.n_rows])
    got = apply_preconditioner(M, torch.from_numpy(w))
    _close(got.numpy(), want, np.float32)
    ref = _substitution(jax_build.build_ilu_jacobi(A, np.float32, steps=1), w)
    _close(got.numpy(), ref, np.float32)


def _args(M, w):
    return (M.lower_bands, M.upper_bands, M.inv_diag, torch.from_numpy(w), M.offs_l, M.offs_u)


@pytest.mark.parametrize("nx", [9, 24])
def test_fp64_exact_ilu_is_the_kernel_route(nx):
    # H100 branch: fp64 exact ILU goes to ExactILUDIAPrec (kernel K6), where
    # the JAX package on the CPU sends it to plain sweeps, steps = levels
    A = jax_synth.convection_diffusion_2d(nx, beta=2.0)
    Mj = jax_build.build_ilu_exact(A, np.float64)
    assert isinstance(Mj, jax_build.ILUJacobiPrec) and Mj.steps == 2 * nx - 1
    M = port_build.build_ilu_exact(_port_csr(A), torch.float64)
    assert isinstance(M, port_build.ExactILUDIAPrec)
    assert M.steps_l == M.steps_u == Mj.steps
    w = np.random.default_rng(nx).standard_normal(A.n_rows)
    got = apply_preconditioner(M, torch.from_numpy(w)).numpy()
    _close(got, np.asarray(jax_apply(Mj, jnp.asarray(w))), np.float64)
    _close(got, _substitution(Mj, w), np.float64)


def test_segmented_plain_matches_jax_kernel(monkeypatch):
    # JAX's budget shrunk as tests/test_precond.py:204-210 does; the port's
    # set to give the same segment
    A = jax_synth.convection_diffusion_2d(60, beta=2.0)  # n = 3600, bands +-1, +-60
    Mj = _jax_exact(A, np.float32, 60_000, monkeypatch)
    assert isinstance(Mj, jax_build.ExactILUDIAPrec) and Mj.seg == 2048
    w = np.random.default_rng(21).standard_normal(A.n_rows).astype(np.float32)
    want = np.asarray(jax_segmented(Mj.lower_bands, Mj.upper_bands, Mj.inv_diag,
                                    jnp.asarray(w), Mj.offs_l, Mj.offs_u, Mj.steps_l_segs,
                                    Mj.steps_u_segs, Mj.seg))
    got = tk.ilu_trisolve_segmented_plain(*_args(_port_state(Mj), w), Mj.steps_l_segs,
                                          Mj.steps_u_segs, Mj.seg)
    _close(got.numpy(), want, np.float32)
    _segments(monkeypatch, A.n_rows, np.float32, 2)
    M = port_build.build_ilu_exact(_port_csr(A), torch.float32)
    assert (M.seg, M.steps_l_segs, M.steps_u_segs) == \
        (Mj.seg, Mj.steps_l_segs, Mj.steps_u_segs)
    assert max(M.steps_l_segs) < M.steps_l  # the neighbour segment is final
    got = apply_preconditioner(M, torch.from_numpy(w))
    _close(got.numpy(), want, np.float32)
    _close(got.numpy(), _substitution(jax_build.build_ilu_jacobi(A, np.float32, 1), w),
           np.float32)


def _segments(monkeypatch, n, dt, n_seg):
    """Set the port's budget so that convdiff's factors (4 bands) of n rows
    split into n_seg segments."""
    working_set = 9 * np.dtype(dt).itemsize * n
    monkeypatch.setattr(port_build, "_TRISOLVE_L2_BYTES", -(-working_set // n_seg))


@pytest.mark.parametrize("n_seg,seg", [(2, 2048), (3, 2048), (4, 1024)])
def test_segmented_fp64_matches_fused_and_substitution(n_seg, seg, monkeypatch):
    # as few equal segments (in multiples of 1024 rows) as the budget
    # allows, the last one partial (n = 3600 is no multiple of seg)
    A = jax_synth.convection_diffusion_2d(60, beta=2.0)
    fused = port_build.build_ilu_exact(_port_csr(A), torch.float64)
    assert fused.seg == 0
    _segments(monkeypatch, A.n_rows, np.float64, n_seg)
    M = port_build.build_ilu_exact(_port_csr(A), torch.float64)
    assert M.seg == seg and len(M.steps_l_segs) == -(-A.n_rows // seg)
    w = torch.from_numpy(np.random.default_rng(n_seg).standard_normal(A.n_rows))
    got = apply_preconditioner(M, w).numpy()
    _close(got, apply_preconditioner(fused, w).numpy(), np.float64)
    _close(got, _substitution(jax_build.build_ilu_jacobi(A, np.float64, 1), w.numpy()),
           np.float64)


def test_identity_tail_segments(monkeypatch):
    # the JAX package's padding (solver/gmres.py:793-799): width rounded up
    # to a segment boundary, identity tail segments of one sweep each
    A = jax_synth.convection_diffusion_2d(60, beta=2.0)
    Mj = _jax_exact(A, np.float32, 60_000, monkeypatch)
    Mp = _pad_prec(Mj, 3 * Mj.seg + 5)
    assert len(Mp.steps_l_segs) == 4 > len(Mj.steps_l_segs) and Mp.steps_l_segs[-1] == 1
    w = np.random.default_rng(4).standard_normal(A.n_rows).astype(np.float32)
    want = tk.ilu_trisolve_segmented_plain(*_args(_port_state(Mj), w), Mj.steps_l_segs,
                                           Mj.steps_u_segs, Mj.seg)
    got = tk.ilu_trisolve_segmented_plain(*_args(_port_state(Mp), w), Mp.steps_l_segs,
                                          Mp.steps_u_segs, Mp.seg)
    assert got.shape == (A.n_rows,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("upper", [True, False], ids=["upper_only", "lower_only"])
def test_one_sided_factors(upper):
    # no lower bands: the L phase is skipped; no upper bands: x = D^-1 b'.
    # (build_ilu_exact sends such factors to plain sweeps, as the JAX package
    # does, so the state is made by hand: one triangle of offsets 1 and 7.)
    n, rng = 50, np.random.default_rng(5)
    offs = (1, 7) if upper else (-7, -1)
    bands = np.zeros((2, n))
    T = np.eye(n)
    for d, off in enumerate(offs):
        rows = np.arange(max(0, -off), min(n, n - off))
        bands[d, rows] = T[rows, rows + off] = 0.5 * rng.standard_normal(rows.size)
    invd = 1.0 / (2.0 + rng.random(n))
    w = rng.standard_normal(n)
    if upper:
        want = np.linalg.solve(T - np.eye(n) + np.diag(1.0 / invd), w)
    else:
        want = invd * np.linalg.solve(T, w)
    t = torch.from_numpy
    empty = t(np.zeros((0, n)))
    ld, ud = (empty, t(bands)) if upper else (t(bands), empty)
    got = tk.ilu_trisolve_fused_plain(ld, ud, t(invd), t(w), () if upper else offs,
                                      offs if upper else (), n, n)
    _close(got.numpy(), want, np.float64)


def _layered_dag(layers=40, width=16, seed=0):
    """Layers of rows, each row coupled to 5 random rows of the previous
    layer (scripts/bench_ilu_exact.py's layered DAG, cut to size): one
    dependency level per layer, a pattern DIA refuses."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for layer in range(layers):
        r = np.arange(layer * width, (layer + 1) * width)
        rows.append(r)
        cols.append(r)
        vals.append(np.full(width, 8.0))
        if layer:
            for _ in range(5):
                rows.append(r)
                cols.append(rng.integers(r[0] - width, r[0], width))
                vals.append(np.full(width, -1.0))
    n = layers * width
    return jax_csr_from_coo(np.concatenate(rows), np.concatenate(cols),
                                  np.concatenate(vals), n_rows=n, n_cols=n)


@DTYPES
def test_level_ilu_matches_jax(dt):
    A = _layered_dag()
    Mj = jax_build.build_ilu_jacobi(A, dt, steps=1)
    rp, ci, _ = _arrays(A)
    diag = jax_ilu0.diag_positions(rp, ci)
    lev_l, lev_u = jax_level.triangular_levels(rp, ci, diag)
    assert lev_l.max() == 39
    Lj, work_j = jax_level.build_level_ilu(Mj.lower, Mj.upper, np.asarray(Mj.inv_diag),
                                           lev_l, lev_u, rows_target=64)
    M = port_build.build_ilu_jacobi(_port_csr(A), TDT[dt], 1)
    L, work = port_level.build_level_ilu(M.lower, M.upper, M.inv_diag.numpy(), lev_l, lev_u,
                                         rows_target=64)
    assert work == work_j and len(L.l_sweeps) > 1
    for name in ("l_cols", "l_vals", "l_segs", "l_rows", "u_cols", "u_vals", "u_rows",
                 "u_invd"):
        assert np.array_equal(getattr(L, name).numpy(), np.asarray(getattr(Lj, name))), name
    assert L.l_sweeps == tuple(np.asarray(Lj.l_sweeps).tolist())
    w = np.random.default_rng(6).standard_normal(A.n_rows).astype(dt)
    want = np.asarray(jax_apply(Lj, jnp.asarray(w)))
    fields = ("l_cols", "l_vals", "l_segs", "l_rows", "l_sweeps", "u_cols", "u_vals",
              "u_segs", "u_rows", "u_sweeps", "u_invd", "inv_diag")
    carried = convert.level_ilu_from_numpy(Lj.l_rows_max, Lj.u_rows_max, Lj.n,
                                           **{f: np.asarray(getattr(Lj, f)) for f in fields})
    for Mp in (L, carried):
        _close(apply_preconditioner(Mp, torch.from_numpy(w)).numpy(), want, dt)
    _close(want, _substitution(Mj, w), dt)


# ------------------------------------------------------------------ routing


def test_shallow_factor_routes_to_sweeps():
    # a red-black ordered 5-point operator has 2 levels per triangle
    nx = 16
    A = jax_synth.convection_diffusion_2d(nx)
    ii, jj = np.divmod(np.arange(nx * nx), nx)
    perm = np.concatenate([np.flatnonzero((ii + jj) % 2 == 0), np.flatnonzero((ii + jj) % 2)])
    Arb = permute_symmetric(A, perm)
    Mj = jax_build.build_ilu_exact(Arb, np.float32)
    M = port_build.build_ilu_exact(_port_csr(Arb), torch.float32)
    assert isinstance(M, port_build.ILUJacobiPrec) and M.steps == Mj.steps == 2
    w = np.random.default_rng(7).standard_normal(Arb.n_rows).astype(np.float32)
    _close(apply_preconditioner(M, torch.from_numpy(w)).numpy(),
           np.asarray(jax_apply(Mj, jnp.asarray(w))), np.float32)


def test_deep_unbanded_factor_routes_to_levels_then_refuses(monkeypatch):
    # full sweeps over budget -> level-scheduled chunks; also over -> refusal
    A = _port_csr(_layered_dag())
    M = port_build.build_ilu_exact(A, torch.float64)
    assert isinstance(M, port_build.ILUJacobiPrec) and M.steps == 40
    monkeypatch.setattr(port_build, "_SWEEP_WORK_BUDGET", 40 * A.nnz - 1)
    monkeypatch.setattr(port_build, "triangular_level_counts", lambda *a: (10**6, 10**6))
    ML = port_build.build_ilu_exact(A, torch.float64)
    assert isinstance(ML, port_level.LevelILUPrec)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(A.n_rows))
    _close(apply_preconditioner(ML, w).numpy(), apply_preconditioner(M, w).numpy(), np.float64)
    real = port_level.build_level_ilu
    monkeypatch.setattr(port_level, "build_level_ilu",
                        lambda *a, **k: (real(*a, **k)[0], port_build._SWEEP_WORK_BUDGET + 1))
    with pytest.raises(ValueError, match="ilu_jacobi"):
        port_build.build_ilu_exact(A, torch.float64)


@pytest.mark.parametrize("precond", ["ilu", "ilu_jacobi"])
def test_ilu_on_a_staged_operator_needs_the_csr_matrix(precond):
    A = convection_diffusion_2d(12)
    cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond=precond, jacobi_steps=3)
    staged = gmres_tpu_torch.stage(A, cfg, device="cpu")
    b = np.ones(A.n_rows)
    with pytest.raises(TypeError, match="CSR"):
        gmres_tpu_torch.solve(staged, b, cfg, device="cpu")
    M = port_build.build_preconditioner(A, cfg)
    assert gmres_tpu_torch.solve(staged, b, cfg.with_(tol=1e-10), M=M, device="cpu").converged


# ------------------------------------------------------------- whole slice


# Mixed ILU-Jacobi: the fp32 sweeps round differently from XLA's fused
# ones (XLA contracts x + D^-1 (b' - U x) into an FMA; 1 ulp in ~40% of
# the entries at n = 4096), and each cycle's residual reduction, computed in
# fp32, carries that to ~3e-3 relative after a few cycles.  The counts are
# held exactly, the per-cycle values to 1e-2 (as for Jacobi in
# tests/test_torch_solver.py:test_graft_entry_config_matches_jax).
ILU_JACOBI_TOL = {"baseline": TOL["baseline"], "mixed": dict(rel=1e-2, x=TOL["mixed"]["x"])}


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_ilu_jacobi_history_matches_jax(mode):
    # tol 1e-9: at 1e-8 both packages end a cycle within 0.3% of the
    # tolerance (9.996e-9 in baseline), where fp32 rounding picks the count
    A = jax_synth.convection_diffusion_2d(64, beta=2.0)
    _, b = _problem(A)
    cj, cp = _configs(mode, precond="ilu_jacobi", jacobi_steps=3, tol=1e-9)
    res_jax = gmres_tpu.solve(A, b, cj, record_history=True)
    res_port = gmres_tpu_torch.solve(_port_csr(A), b, cp, record_history=True, device="cpu")
    assert (res_port.restarts, res_port.total_iters) == (5, 150)
    _agree(res_jax, res_port, ILU_JACOBI_TOL[mode])


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_exact_ilu_history_matches_jax(mode):
    A = jax_synth.convection_diffusion_2d(32, beta=2.0)
    _, b = _problem(A)
    cj, cp = _configs(mode, precond="ilu")
    # JAX on the CPU: fp64 -> plain sweeps, fp32 -> the fused kernel; the
    # port: the kernel route in both
    Mj = jax_build.build_preconditioner(A, cj)
    assert isinstance(Mj, jax_build.ILUJacobiPrec if mode == "baseline"
                      else jax_build.ExactILUDIAPrec)
    assert isinstance(port_build.build_preconditioner(_port_csr(A), cp),
                      port_build.ExactILUDIAPrec)
    res_jax = gmres_tpu.solve(A, b, cj, record_history=True)
    res_port = gmres_tpu_torch.solve(_port_csr(A), b, cp, record_history=True, device="cpu")
    assert (res_port.restarts, res_port.total_iters) == (1, 30)
    # one cycle reaches ~5e-9 in mixed, at fp32's rounding floor (FLOOR)
    _agree(res_jax, res_port, TOL[mode], FLOOR[mode])


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
@pytest.mark.parametrize("precond", ["ilu_jacobi", "ilu"])
def test_ilu_matches_dense_oracle(precond, mode):
    # the oracle runs ILU-Jacobi sweeps; with steps = the level count
    # (2*24 - 1) they are the exact substitution
    A = jax_synth.convection_diffusion_2d(24, beta=1.0)
    _, b = _problem(A)
    steps = 3 if precond == "ilu_jacobi" else 47
    ref = oracle_solve(_dense(A), b, tol=1e-10, rlen=20, max_restarts=400, orth="cgsr",
                       mode=mode, policy="fixed", ilu_jacobi_steps=steps)
    _, cp = _configs(mode, precond=precond, jacobi_steps=3, restart_length=20, tol=1e-10,
                     max_restarts=400)
    res = gmres_tpu_torch.solve(_port_csr(A), b, cp, device="cpu")
    assert ref.converged and res.converged
    assert abs(res.restarts - ref.restarts) <= 1
    assert abs(res.total_iters - ref.total_iters) <= max(2, 0.05 * ref.total_iters)
