"""The port's sliced ELL (``gmres_tpu_torch/ops/sell.py``, the plain versions
of kernel K5 on the CPU) and its RCM reordering against the JAX package.

The two packs share no arrays (the JAX one is shaped for the TPU), so the
comparisons are of what the SpMV computes on the same operator and x:
- fp32: the port's plain SpMV against ``sell_spmv_pallas`` in interpret
  mode, entry by entry within 1e-5 of the same product on absolute values
  (|A| |x|), the scale of the fp32 summation error bound (the two sum
  ~10-60 products in different orders);
- fp64: against ``sell_spmv_xla`` within 1e-13 of |A| |x|, and the residual
  mode's r against ``sell_spmv_df64`` in interpret mode (double-float,
  ~2^-48 relative) within 1e-11 relative, and against scipy within 1e-13.

Every call of the JAX package's ``sell_from_csr`` runs its numpy engine
(``GMRES_TPU_SELL_NUMPY=1``), so these tests never build its native
library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu_torch
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.ops import reorder as jax_reorder
from gmres_tpu.ops.pallas.sell_kernel import sell_spmv_df64, sell_spmv_pallas
from gmres_tpu.ops.sell import sell_from_csr as jax_sell_from_csr
from gmres_tpu.ops.sell import sell_spmv_xla
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.io import synth
from gmres_tpu_torch.ops import reorder
from gmres_tpu_torch.ops.cuda.outer_kernel import outer_residual
from gmres_tpu_torch.ops.cuda.sell_kernel import sell_residual_plain
from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.ops.sell import MAX_PADDING, SELLMatrix, sell_from_csr, sell_spmv
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.sparse import CSRMatrix, csr_from_arrays, csr_from_coo


@pytest.fixture(autouse=True)
def _numpy_packer(monkeypatch):
    monkeypatch.setenv("GMRES_TPU_SELL_NUMPY", "1")


def _local(n, avg_nnz, spread, seed):
    """Scattered within [i - spread/2, i + spread/2) of the diagonal (the
    post-RCM shape of tests/test_sell.py:_random_local_csr), vectorised."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 2 * avg_nnz, size=n)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-spread // 2, spread // 2, size=rows.size), 0, n - 1)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    return rows, cols


def _long_row(n, seed):
    """Three entries a row and one row of 40 (tests/test_sell.py:65-82)."""
    rng = np.random.default_rng(seed)
    k = np.where(np.arange(n) == 57, 40, 3)
    rows = np.repeat(np.arange(n), k)
    return rows, rng.integers(0, n, size=rows.size)


def _dense_block(n, seed):
    """Rows 0..255 densely coupled to columns 0..127 (the TPU pack's dense
    blocks, tests/test_sell.py:161-196) over a sparse local pattern."""
    rng = np.random.default_rng(seed)
    rows = [np.repeat(np.arange(256), 50), np.repeat(np.arange(n), 3), np.arange(n)]
    cols = [rng.integers(0, 128, size=256 * 50),
            np.clip(np.repeat(np.arange(n), 3) + rng.integers(-60, 60, size=3 * n), 0, n - 1),
            np.arange(n)]
    return np.concatenate(rows), np.concatenate(cols)


PATTERNS = {
    "local": lambda: _local(1500, 6, 700, 5),
    "long_row": lambda: _long_row(1500, 3),
    "dense_block": lambda: _dense_block(1500, 11),
    "mesh": lambda: None,
}
# the JAX pack's (W, K) for each pattern, as its own tests pin them
JAX_WK = {"local": {}, "long_row": dict(W=128, K=4), "dense_block": dict(W=128, K=4), "mesh": {}}


def _pair(pattern, seed=0):
    """The same fp64 operator as a JAX and a port CSR matrix."""
    if pattern == "mesh":
        A = jax_synth.unstructured_mesh(1500, run=3)
    else:
        rows, cols = PATTERNS[pattern]()
        vals = np.random.default_rng(seed).standard_normal(rows.size)
        # values that need more than fp32's 24 bits
        vals *= 1.0 + 1e-9 * np.random.default_rng(seed + 1).standard_normal(rows.size)
        A = jax_csr_from_coo(rows, cols, vals, n_rows=1500)
    port = csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                          n_cols=A.n_cols)
    return A, port


def _abs_product(port, x):
    S = port.to_scipy()
    return abs(S) @ np.abs(x)


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_sell_spmv_f32_matches_pallas_kernel(pattern):
    A, port = _pair(pattern)
    S_jax = jax_sell_from_csr(A, **JAX_WK[pattern])
    assert S_jax is not None
    x = np.random.default_rng(6).standard_normal(A.n_rows).astype(np.float32)
    want = np.asarray(sell_spmv_pallas(S_jax.astype(jnp.float32), jnp.asarray(x),
                                       interpret=True))
    S = sell_from_csr(port)
    assert isinstance(S, SELLMatrix) and S.nnz == A.nnz
    got = sell_spmv(S.astype(torch.float32), torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    scale = _abs_product(port, x.astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-5 * scale)


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_sell_spmv_f64_matches_xla_path(pattern):
    A, port = _pair(pattern, seed=1)
    S_jax = jax_sell_from_csr(A, **JAX_WK[pattern])
    x = np.random.default_rng(7).standard_normal(A.n_rows)
    want = np.asarray(sell_spmv_xla(S_jax, jnp.asarray(x)))
    got = sell_spmv(sell_from_csr(port), torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - want) <= 1e-13 * _abs_product(port, x))


@pytest.mark.parametrize("pattern", ["local", "dense_block", "mesh"])
def test_sell_residual_f64_matches_double_float_kernel(pattern):
    A, port = _pair(pattern, seed=2)
    S_jax = jax_sell_from_csr(A, df64=True, **JAX_WK[pattern])
    rng = np.random.default_rng(8)
    x = rng.standard_normal(A.n_rows)
    b = rng.standard_normal(A.n_rows)
    xh = x.astype(np.float32)
    xl = (x - xh.astype(np.float64)).astype(np.float32)
    yh, yl = sell_spmv_df64(S_jax, jnp.asarray(xh), jnp.asarray(xl), interpret=True)
    want = b - (np.asarray(yh, np.float64) + np.asarray(yl, np.float64))
    exact = b - port.to_scipy() @ x

    S = sell_from_csr(port)
    r, r_sq, x_sq = sell_residual_plain(S.vals, S.cols, S.slice_ptr, torch.from_numpy(b),
                                        torch.from_numpy(x), torch.float32)
    r = r.numpy()
    assert np.linalg.norm(r - want) <= 1e-11 * np.linalg.norm(want)
    assert np.linalg.norm(r - exact) <= 1e-13 * np.linalg.norm(exact)
    # ||fp32(r)||^2 summed in fp32, ||x||^2 in fp64
    r32 = r.astype(np.float32)
    np.testing.assert_allclose(float(r_sq), float(np.dot(r32, r32)), rtol=1e-5)
    np.testing.assert_allclose(float(x_sq), float(np.dot(x, x)), rtol=1e-14)
    # the solver's outer phase reaches the same residual mode
    r2, _, _ = outer_residual(S, torch.from_numpy(b), torch.from_numpy(x), torch.float64)
    assert np.array_equal(r2.numpy(), r)


def _scipy_check(A: CSRMatrix, S: SELLMatrix, seed=0):
    """The plain SpMV against scipy, in fp64 and in fp32."""
    x = np.random.default_rng(seed).standard_normal(A.n_cols)
    want = A.to_scipy() @ x
    scale = abs(A.to_scipy()) @ np.abs(x)
    got = spmv(S, torch.from_numpy(x)).numpy()
    assert got.shape == (A.n_rows,)
    assert np.all(np.abs(got - want) <= 1e-13 * scale + 1e-300)
    got32 = spmv(S.astype(torch.float32), torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got32 - want) <= 1e-5 * scale + 1e-300)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_pack_ragged_last_slice(n):
    A = synth.random_sparse(n, row_nnz=5, seed=n)
    S = sell_from_csr(A, max_padding=64.0)
    assert S.slice_ptr.shape == (-(-n // 32) + 1,)
    _scipy_check(A, S, seed=n)


def test_pack_empty_rows_and_slices():
    # rows 40..99 (all of slices 2 and most of 1 and 3) and every 7th row
    # store nothing; y is 0 there
    rng = np.random.default_rng(1)
    n = 200
    keep = (np.arange(n) % 7 != 0) & ((np.arange(n) < 40) | (np.arange(n) >= 100))
    rows = np.repeat(np.flatnonzero(keep), 4)
    cols = rng.integers(0, n, size=rows.size)
    A = csr_from_coo(rows, cols, rng.standard_normal(rows.size), n_rows=n)
    S = sell_from_csr(A, max_padding=64.0)
    widths = (torch.diff(S.slice_ptr) // 32).tolist()
    assert widths[2] == 0 and min(widths[:2] + widths[3:]) > 0
    _scipy_check(A, S)
    y = spmv(S, torch.ones(n, dtype=torch.float64)).numpy()
    assert np.all(y[~keep] == 0)


def test_pack_unsorted_columns_and_duplicates():
    # valid CSR needs neither sorted columns nor unique (row, col) pairs;
    # each row keeps its entry order and duplicates add
    rng = np.random.default_rng(7)
    n = 2000
    lengths = rng.integers(1, 12, size=n)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)])
    rows = np.repeat(np.arange(n), lengths)
    cols = np.clip(rows + rng.integers(-300, 300, size=rows.size), 0, n - 1)
    first = row_ptr[:-1][lengths >= 2]
    cols[first + 1] = cols[first]  # a duplicate in every row of 2 or more
    perm = np.argsort(rng.random(rows.size) + rows)  # shuffle within rows
    A = csr_from_arrays(row_ptr, cols[perm], rng.standard_normal(rows.size))
    assert not np.all(np.diff(A.col_idx.numpy())[np.diff(A.row_ids.numpy()) == 0] > 0)
    S = sell_from_csr(A)
    assert S.nnz == A.nnz
    _scipy_check(A, S)


@pytest.mark.parametrize("n_cols", [300, 3000])
def test_pack_rectangular(n_cols):
    # x is n_cols long; padding columns stay inside it
    rng = np.random.default_rng(n_cols)
    n = 1000
    rows = np.repeat(np.arange(n), 6)
    cols = rng.integers(0, n_cols, size=rows.size)
    A = csr_from_coo(rows, cols, rng.standard_normal(rows.size), n_rows=n, n_cols=n_cols)
    S = sell_from_csr(A)
    assert S.shape == (n, n_cols)
    assert int(S.cols.min()) >= 0 and int(S.cols.max()) < n_cols
    _scipy_check(A, S)


def test_pack_layout():
    A = synth.unstructured_mesh(1000, run=3)
    S = sell_from_csr(A)
    rp, ci, v = A.numpy_arrays()
    lengths = np.diff(rp)
    widths = torch.diff(S.slice_ptr).numpy() // 32
    padded = np.zeros(32 * len(widths), dtype=np.int64)
    padded[:1000] = lengths
    assert np.array_equal(widths, padded.reshape(-1, 32).max(axis=1))
    assert S.vals.dtype == torch.float64 and S.cols.dtype == torch.int32
    assert S.slice_ptr.dtype == torch.int64 and S.n_slots == int(S.slice_ptr[-1])
    assert S.padding == S.n_slots / A.nnz and 1.0 <= S.padding < 1.5
    # row 37 (slice 1, lane 5): its entries in order, then padding slots
    # with value 0 and the row's own column
    base, w = int(S.slice_ptr[1]), int(widths[1])
    slots = base + 32 * np.arange(w) + 5
    k = lengths[37]
    assert np.array_equal(S.cols.numpy()[slots[:k]], ci[rp[37]:rp[38]])
    assert np.array_equal(S.vals.numpy()[slots[:k]], v[rp[37]:rp[38]])
    assert np.all(S.vals.numpy()[slots[k:]] == 0) and np.all(S.cols.numpy()[slots[k:]] == 37)
    # astype shares the index arrays; to() moves all three
    S32 = S.astype(torch.float32)
    assert S32.dtype == torch.float32 and S32.cols is S.cols and S32.slice_ptr is S.slice_ptr
    assert S.to("cpu").device == torch.device("cpu")


def test_pack_refuses():
    # one row of ~200 in every slice of 1-entry rows pads ~28x
    n = 3200
    lengths = np.where(np.arange(n) % 32 == 0, 200, 1)
    rows = np.repeat(np.arange(n), lengths)
    cols = np.random.default_rng(0).integers(0, n, size=rows.size)
    A = csr_from_coo(rows, cols, np.ones(rows.size), n_rows=n)
    assert sell_from_csr(A) is None
    S = sell_from_csr(A, max_padding=30.0)
    assert S.padding == S.n_slots / A.nnz > MAX_PADDING
    assert sell_from_csr(csr_from_coo([], [], np.zeros(0), n_rows=8)) is None


@pytest.mark.parametrize("case,fmt", [
    ("convdiff", DIAMatrix), ("mesh", SELLMatrix), ("padded", CSRMatrix)])
def test_stage_picks_dia_then_sell_then_csr(case, fmt):
    if case == "convdiff":
        A = synth.convection_diffusion_2d(20)
    elif case == "mesh":
        A = synth.unstructured_mesh(4096, run=8)
    else:  # DIA and SELL both refuse
        n = 3200
        rows = np.repeat(np.arange(n), np.where(np.arange(n) % 32 == 0, 200, 1))
        cols = np.random.default_rng(0).integers(0, n, size=rows.size)
        A = csr_from_coo(rows, cols, np.ones(rows.size), n_rows=n)
    cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond="identity")
    assert type(gmres_tpu_torch.stage(A, cfg, device="cpu")) is fmt
    assert type(gmres_tpu_torch.stage(A, cfg.with_(auto_format=False), device="cpu")) is CSRMatrix


@pytest.mark.parametrize("builder,args", [
    ("random_sparse", (300, 6)),
    ("unstructured_mesh", (1024, None, 16, 3)),
    ("convection_diffusion_2d", (17, 23)),
])
def test_rcm_bit_identical(builder, args):
    ref = getattr(jax_synth, builder)(*args)
    port = getattr(synth, builder)(*args)
    perm = reorder.rcm_permutation(port)
    assert np.array_equal(perm, jax_reorder.rcm_permutation(ref))
    got, want = reorder.permute_symmetric(port, perm), jax_reorder.permute_symmetric(ref, perm)
    assert np.array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    assert np.array_equal(got.col_idx.numpy(), np.asarray(want.col_idx)[: want.nnz])
    assert np.array_equal(got.vals.numpy().view(np.uint64),
                          np.asarray(want.vals)[: want.nnz].view(np.uint64))
    assert reorder.bandwidth(got) == jax_reorder.bandwidth(want)
    assert reorder.bandwidth(port) == jax_reorder.bandwidth(ref)
