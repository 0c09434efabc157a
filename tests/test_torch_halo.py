"""The distributed slice's host partitioners and its kernel: ``parallel/
partition.py`` and ``parallel/halo.py:partition_halo`` held bit for bit to
the JAX package's, K12's plain versions (``ops/cuda/halo_kernel.py``) held to
the JAX package's windowed Pallas DIA kernel in interpret mode and to numpy,
and the halo exchange and the distributed SpMV over gloo ranks on the CPU.

K12's plain version sums in band order like the JAX kernel; tolerances:
fp32 1e-6 and fp64 1e-13 of the same product on absolute values.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import gmres_tpu.parallel.halo as jax_halo
import gmres_tpu_torch
import gmres_tpu.parallel.partition as jax_part
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.ops.pallas.spmv_kernel import dia_spmv_pallas_windowed
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.ops.cuda.halo_kernel import dia_residual_halo_plain, dia_spmv_halo_plain
from gmres_tpu_torch.parallel import launch
from gmres_tpu_torch.parallel.comm import Comm
from gmres_tpu_torch.parallel.dist_gmres import spmv_distributed
from gmres_tpu_torch.parallel.halo import HaloCSR, HaloDIA, partition_halo
from gmres_tpu_torch.parallel.partition import pad_vector, padded_size, partition_rows


def neighbour_local(n=96, seed=3, per_row=3, diag=8.0):
    """A pattern within +-7 of the diagonal with too many distinct diagonals
    for DIA (the pattern of tests/test_halo.py:61, thinned to 3 random entries
    a row plus a dominant diagonal so that it is also well solvable)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        js = np.unique(np.clip(i + rng.integers(-7, 8, size=per_row), 0, n - 1))
        rows += [i] * len(js) + [i]
        cols += js.tolist() + [i]
        vals += rng.standard_normal(len(js)).tolist() + [diag]
    return jax_csr_from_coo(np.array(rows), np.array(cols), np.array(vals), n_rows=n)


MATRICES = {
    "poisson16": lambda: jax_synth.poisson_2d(16),
    "convdiff9": lambda: jax_synth.convection_diffusion_2d(9),   # n = 81: padded rows
    "neighbour_local": neighbour_local,
    "global": lambda: jax_synth.random_sparse(128, row_nnz=6, seed=1),
}


def port_csr(A):
    return csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                          n_cols=A.n_cols)


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("P", [4])
def test_partition_rows_bit_identical(name, P):
    A = MATRICES[name]()
    got, want = partition_rows(port_csr(A), P), jax_part.partition_rows(A, P)
    for f in ("row_ptr", "col_idx", "row_ids", "vals"):
        assert bits_equal(getattr(got, f), getattr(want, f)), f
    assert (got.n_shards, got.rows_per_shard, got.n_cols, got.nnz) == (
        want.n_shards, want.rows_per_shard, want.n_cols, want.nnz)


@pytest.mark.parametrize("name", list(MATRICES))
def test_partition_halo_bit_identical(name):
    A = MATRICES[name]()
    got, want = partition_halo(port_csr(A), 4), jax_halo.partition_halo(A, 4)
    kind = {"poisson16": HaloDIA, "convdiff9": HaloDIA, "neighbour_local": HaloCSR,
            "global": type(None)}[name]
    assert isinstance(got, kind) and type(want).__name__ == kind.__name__
    if want is None:
        return
    meta = ("n_shards", "rows_per_shard", "halo_left", "halo_right", "nnz")
    assert [getattr(got, f) for f in meta] == [getattr(want, f) for f in meta]
    fields = (("data",) if kind is HaloDIA else ("row_ptr", "col_idx", "row_ids", "vals"))
    for f in fields:
        assert bits_equal(getattr(got, f), getattr(want, f)), f
    if kind is HaloDIA:
        assert got.offsets == want.offsets


def test_pad_vector_matches():
    v = np.arange(81, dtype=np.float64)
    assert padded_size(81, 4) == jax_part.padded_size(81, 4) == 84
    assert bits_equal(pad_vector(v, 4), jax_part.pad_vector(v, 4))


R, OFFSETS = 2048, (-64, -1, 0, 1, 64)
TOL = {np.float32: 1e-6, np.float64: 1e-13}


def window_case(dtype, hl, hr, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(OFFSETS), R)).astype(dtype)
    x, left, right = (rng.standard_normal(k).astype(dtype) for k in (R, hl, hr))
    return data, x, left, right


@pytest.mark.parametrize("hl,hr", [(0, 0), (128, 0), (0, 128), (128, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_spmv_halo_plain_matches_pallas_windowed(dtype, hl, hr):
    data, x, left, right = window_case(dtype, hl, hr)
    xx = np.concatenate([left, x, right])
    want = np.asarray(dia_spmv_pallas_windowed(data, xx, hl, hr, OFFSETS, interpret=True))
    t = torch.from_numpy
    got = dia_spmv_halo_plain(t(data), OFFSETS, t(x), t(left), t(right)).numpy()
    scale = dia_spmv_halo_plain(t(np.abs(data)), OFFSETS, t(np.abs(x)), t(np.abs(left)),
                                t(np.abs(right))).numpy()
    assert got.dtype == want.dtype == dtype
    assert np.abs(got - want).max() <= TOL[dtype] * scale.max()


@pytest.mark.parametrize("inner", [torch.float32, torch.float64])
@pytest.mark.parametrize("hl,hr", [(0, 128), (128, 128)])
def test_dia_residual_halo_plain_matches_numpy(hl, hr, inner):
    data, x, left, right = window_case(np.float64, hl, hr, seed=1)
    b = np.random.default_rng(2).standard_normal(R)
    # r = b - A xv over the window [left | x | right] in fp64 numpy
    xx = np.concatenate([left, x, right])
    y = np.zeros(R)
    for d, off in enumerate(OFFSETS):
        idx = hl + np.arange(R) + off
        ok = (idx >= 0) & (idx < xx.size)
        y[ok] += data[d][ok] * xx[idx[ok]]
    want_r = b - y
    t = torch.from_numpy
    r, r_ss, x_ss = dia_residual_halo_plain(t(data), OFFSETS, t(b), t(x), t(left), t(right),
                                            inner)
    scale = np.abs(b) + dia_spmv_halo_plain(t(np.abs(data)), OFFSETS, t(np.abs(x)),
                                            t(np.abs(left)), t(np.abs(right))).numpy()
    assert np.abs(r.numpy() - want_r).max() <= 1e-13 * scale.max()
    ri = want_r.astype(np.float32).astype(np.float64) if inner == torch.float32 else want_r
    ss_tol = 1e-6 if inner == torch.float32 else 1e-13
    assert r_ss.dtype == x_ss.dtype == torch.float64
    assert abs(float(r_ss) - ri @ ri) <= ss_tol * (ri @ ri)
    assert abs(float(x_ss) - x @ x) <= 1e-13 * (x @ x)


def test_exchange_halos_single_rank_gets_zeros(tmp_path):
    # P = 1, in this process: no neighbour on either side, both edges are
    # zeros
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", rank=0,
                            world_size=1)
    try:
        comm = Comm()
        x = torch.arange(1.0, 11.0, dtype=torch.float64)
        left, right = comm.exchange_halos(x, 3, 2)
        assert torch.equal(left, torch.zeros(3, dtype=torch.float64))
        assert torch.equal(right, torch.zeros(2, dtype=torch.float64))
        assert torch.equal(comm.all_gather(x), x)
        assert torch.equal(comm.all_reduce_sum(x), x)
        if not torch.cuda.is_available():  # CUDA by default, never the CPU by itself
            with pytest.raises(RuntimeError, match="CUDA"):
                gmres_tpu_torch.solve_distributed(
                    port_csr(jax_synth.poisson_2d(4)), np.ones(16),
                    gmres_tpu_torch.GmresConfig(orth="cgsr", precond="identity"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["convdiff9", "neighbour_local"])
def test_spmv_distributed_over_two_ranks_matches_global(name):
    # P = 2: the halo exchange across the one inner boundary, zeros on the
    # outer ones (DIA and rebased-CSR blocks)
    A = MATRICES[name]()
    x = np.random.default_rng(5).standard_normal(A.n_rows)
    want = A.to_scipy() @ x
    for y in launch.spawn(spmv_distributed, 2, args=(port_csr(A), x, None, "cpu")):
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
