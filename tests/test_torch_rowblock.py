"""Per-host row-block input and per-host partitioning of the distributed
port (``RowBlockCSR``, ``io/loader.py:load_matrix_rows``,
``parallel/multihost.py``, the ``owned``/``exchange`` branches of
``parallel/partition.py`` and ``parallel/halo.py``,
``precond/build.py:build_jacobi_rowblock``,
``parallel/dist_gmres.py:process_row_range``) against the JAX package's.

Held to, bit for bit unless a bound is given:
- ``read_coordinate_rows`` (chunked) and ``load_matrix_rows``: the JAX
  package's arrays; the blocks concatenate to ``load_matrix``'s arrays
  (general and symmetric files, duplicate entries);
- each rank's build from its own rows, the metadata through an exchange
  over threads (``torch_rank_helpers.run_threaded``): the Jacobi inverse
  diagonal equals ``build_jacobi`` of the whole matrix; the row and halo
  partitions in owned mode equal the global ones; ``rowblock_dia_gate``
  equals the global DIA check and the JAX package's gate;
- ``process_row_range``: the JAX package's range for every grid and
  ``fmt``, and its refusal of non-contiguous shards; ``RowBlockCSR`` input
  refuses the global ILU preconditioners with its message;
- solves on four gloo ranks (one spawn, the CPU), each rank loading its
  own rows of a ``.mtx`` file: the counts and x of the whole-matrix
  distributed solve of the same configuration (identity, Jacobi,
  bilu_jacobi, and ``force_sell`` on an unstructured matrix), and of
  ``multihost=True``, each from about 1/P of the partitioned bytes (within
  a fifth); against the JAX package's ``solve_distributed`` on a
  ``RowBlockCSR`` of the whole range: restarts within one, x within 1e-6;
  against the dense oracle: restarts within one, x within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io import loader as jax_loader
from gmres_tpu.io import mmio as jax_mmio
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.parallel import dist_gmres as jax_dist
from gmres_tpu.parallel import halo as jax_halo
from gmres_tpu.parallel.dist_gmres import AXIS
from gmres_tpu.sparse import RowBlockCSR as JaxRowBlockCSR
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.io import loader, mmio
from gmres_tpu_torch.io import synth as port_synth
from gmres_tpu_torch.io.rng import rand_vect
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.parallel import dist_gmres, halo, launch, partition
from gmres_tpu_torch.precond.build import build_jacobi, build_jacobi_rowblock
from gmres_tpu_torch.sparse import RowBlockCSR

import torch_rank_helpers
from oracle_gmres import oracle_solve

P = 4
KW = dict(orth="cgsr", restart_length=12, tol=1e-9, max_restarts=100)


def _write(path, A, symmetric=False):
    """A as a coordinate file: every entry, or the lower triangle of a
    symmetric A."""
    rp, ci, v = A.numpy_arrays()
    rows = np.repeat(np.arange(A.n_rows), np.diff(rp))
    keep = ci <= rows if symmetric else np.ones(rows.shape, bool)
    mmio.write_coordinate(path, A.n_rows, A.n_cols, rows[keep], ci[keep], v[keep],
                          symmetry="symmetric" if symmetric else "general")
    return str(path)


def _dup_matrix(tmp_path):
    """A general file with duplicate off-diagonal entries and rows without
    a stored diagonal."""
    rng = np.random.default_rng(3)
    n, m = 50, 400
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    path = str(tmp_path / "dup.mtx")
    mmio.write_coordinate(path, n, n, r, c, rng.standard_normal(m))
    return path


def _files(tmp_path):
    return {"general": _dup_matrix(tmp_path),
            "symmetric": _write(tmp_path / "sym.mtx", port_synth.poisson_2d(9),
                                symmetric=True),
            "convdiff": _write(tmp_path / "cd.mtx",
                               port_synth.convection_diffusion_2d(12))}


@pytest.mark.parametrize("kind", ["general", "symmetric", "convdiff"])
def test_load_matrix_rows_matches_jax_and_concatenates(kind, tmp_path):
    path = _files(tmp_path)[kind]
    full = loader.load_matrix(path)
    rp, ci, v = full.numpy_arrays()
    n = full.n_rows
    cuts = [0, n // 5, n // 2, n // 2, n]
    parts_ci, parts_v = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        blk = loader.load_matrix_rows(path, lo, hi)
        ref = jax_loader.load_matrix_rows(path, lo, hi)
        assert isinstance(blk, RowBlockCSR) and (blk.row_lo, blk.row_hi) == (lo, hi)
        np.testing.assert_array_equal(blk.row_ptr, rp)
        np.testing.assert_array_equal(blk.row_ptr, ref.row_ptr)
        for got, want in zip(blk.entries(lo, hi), ref.entries(lo, hi)):
            np.testing.assert_array_equal(got, want)
        parts_ci.append(blk.entries(lo, hi)[0])
        parts_v.append(blk.entries(lo, hi)[1])
    np.testing.assert_array_equal(np.concatenate(parts_ci), ci)
    assert np.concatenate(parts_v).tobytes() == v.tobytes()


@pytest.mark.parametrize("chunk", [64, 1 << 20])
def test_read_coordinate_rows_matches_jax(chunk, tmp_path):
    path = _files(tmp_path)["symmetric"]
    got = mmio.read_coordinate_rows(path, 20, 50, chunk_bytes=chunk)
    want = jax_mmio.read_coordinate_rows(path, 20, 50, chunk_bytes=chunk)
    assert got[0].n_rows == want[0].n_rows
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _blocks(A, n_ranks, rows_per=None):
    r = rows_per or -(-A.n_rows // n_ranks)
    rp = A.row_ptr.numpy()
    out = []
    for s in range(n_ranks):
        lo, hi = min(s * r, A.n_rows), min((s + 1) * r, A.n_rows)
        out.append(RowBlockCSR(row_ptr=rp, col_idx=A.col_idx.numpy()[rp[lo]:rp[hi]],
                               vals=A.vals.numpy()[rp[lo]:rp[hi]], row_lo=lo, row_hi=hi,
                               n_rows=A.n_rows, n_cols=A.n_cols))
    return out


def _port(A):
    return csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jacobi_rowblock_equals_global(dtype):
    A = _port(jax_synth.convection_diffusion_2d(13))
    blocks = _blocks(A, P)
    got = torch_rank_helpers.run_threaded(
        lambda rank, ex: build_jacobi_rowblock(blocks[rank], dtype, ex), P)
    want = build_jacobi(A, dtype).inv_diag
    for M in got:
        assert M.inv_diag.dtype == dtype and torch.equal(M.inv_diag, want)


@pytest.mark.parametrize("make", [
    lambda: jax_synth.convection_diffusion_2d(13),            # DIA
    lambda: jax_synth.unstructured_mesh(600, run=3, seed=4),   # scattered
])
def test_owned_partitions_equal_global(make):
    A_j = make()
    A = _port(A_j)
    blocks = _blocks(A, P)
    full_rows = partition.partition_rows(A, P)
    full_halo = halo.partition_halo(A, P)
    jax_halo_full = jax_halo.partition_halo(A_j, P)
    assert type(full_halo).__name__ == type(jax_halo_full).__name__

    def per_rank(rank, ex):
        return (partition.partition_rows(A, P, owned={rank}),
                partition.partition_rows(blocks[rank], P, owned={rank}),
                halo.partition_halo(A, P, owned={rank}),
                halo.partition_halo(blocks[rank], P, owned={rank}, exchange=ex))

    for rank, parts in enumerate(torch_rank_helpers.run_threaded(per_rank, P)):
        for got in parts[:2]:
            for name in ("row_ptr", "col_idx", "row_ids", "vals"):
                np.testing.assert_array_equal(getattr(got, name)[rank],
                                              getattr(full_rows, name)[rank])
        for got in parts[2:]:
            if full_halo is None:
                assert got is None
                continue
            assert type(got) is type(full_halo)
            names = ("data",) if isinstance(got, halo.HaloDIA) else ("row_ptr", "col_idx",
                                                                    "row_ids", "vals")
            for name in names:
                np.testing.assert_array_equal(getattr(got, name)[rank],
                                              getattr(full_halo, name)[rank])
                np.testing.assert_array_equal(getattr(got, name)[rank],
                                              np.asarray(getattr(jax_halo_full, name))[rank])
            assert (got.halo_left, got.halo_right) == (full_halo.halo_left,
                                                       full_halo.halo_right)


@pytest.mark.parametrize("make", [
    lambda: jax_synth.convection_diffusion_2d(13),
    lambda: jax_synth.unstructured_mesh(600, run=3, seed=4),
    lambda: jax_synth.random_sparse(300, 6, seed=1),
])
def test_rowblock_dia_gate_equals_global_check(make):
    A_j = make()
    A = _port(A_j)
    blocks = _blocks(A, P)
    votes = torch_rank_helpers.run_threaded(
        lambda rank, ex: halo.rowblock_dia_gate(blocks[rank], ex), P)
    want = from_csr(A) is not None
    assert votes == [want] * P
    assert jax_halo.rowblock_dia_gate(A_j) == want == halo.rowblock_dia_gate(A)


@pytest.mark.parametrize("n,owned,rows_per,fmt", [
    (1000, [0], None, "csr"), (1000, [3], None, "csr"), (1000, [1, 2], None, "csr"),
    (1000, [2], 512, "csr"), (5000, [1], None, "auto"), (70000, [3], None, "auto"),
    (1000, [], None, "csr")])
def test_process_row_range_matches_jax(n, owned, rows_per, fmt):
    mesh = Mesh(np.array(jax.devices()[:P]), (AXIS,))
    want = jax_dist.process_row_range(mesh, n, owned=owned, rows_per=rows_per, fmt=fmt)
    assert dist_gmres.process_row_range(n, P, owned, rows_per, fmt) == want


def test_process_row_range_refuses_noncontiguous_shards():
    mesh = Mesh(np.array(jax.devices()[:P]), (AXIS,))
    with pytest.raises(ValueError) as want:
        jax_dist.process_row_range(mesh, 1000, owned=[0, 2])
    with pytest.raises(ValueError) as got:
        dist_gmres.process_row_range(1000, P, [0, 2])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("precond", ["ilu_jacobi", "ilu"])
def test_rowblock_refuses_global_ilu(precond):
    A = _port(jax_synth.convection_diffusion_2d(8))
    A_j = jax_synth.convection_diffusion_2d(8)
    blk = _blocks(A, 1)[0]
    rp = np.asarray(A_j.row_ptr).astype(np.int64)
    blk_j = JaxRowBlockCSR(row_ptr=rp, col_idx=np.asarray(A_j.col_idx)[:rp[-1]],
                           vals=np.asarray(A_j.vals)[:rp[-1]], row_lo=0, row_hi=64, n_rows=64,
                           n_cols=64)
    with pytest.raises(ValueError) as want:
        jax_dist.solve_distributed(blk_j, np.ones(64), gmres_tpu.GmresConfig(precond=precond))
    if precond == "ilu":  # distributed exact ILU is refused before the input form is read
        with pytest.raises(NotImplementedError, match="distributed exact ILU"):
            gmres_tpu_torch.solve_distributed(blk, np.ones(64),
                                              gmres_tpu_torch.GmresConfig(precond=precond))
        return
    with pytest.raises(ValueError) as got:
        gmres_tpu_torch.solve_distributed(blk, np.ones(64),
                                          gmres_tpu_torch.GmresConfig(precond=precond))
    assert str(got.value) == str(want.value)


# label -> (file, precond, extra case keys)
SOLVES = {
    "identity": ("convdiff", "identity", {}),
    "jacobi": ("convdiff", "jacobi", {}),
    "bilu": ("convdiff", "bilu_jacobi", {}),
    "force-sell": ("mesh", "identity", dict(force_sell=True)),
}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rowblock")
    paths = {"convdiff": _write(tmp / "cd.mtx",
                                port_synth.convection_diffusion_2d(12)),
             "mesh": _write(tmp / "mesh.mtx",
                            port_synth.unstructured_mesh(3000, run=3, seed=6))}
    cases = []
    for label, (kind, precond, extra) in SOLVES.items():
        A = loader.load_matrix(paths[kind])
        b = A.to_scipy() @ rand_vect(A.n_rows, 42)
        cfg = gmres_tpu_torch.GmresConfig(
            precision=gmres_tpu_torch.PrecisionSpec.from_mode("mixed"), precond=precond,
            jacobi_steps=3, **KW)
        common = dict(b=b, cfg=cfg, **extra)
        cases += [dict(common, label=f"{label} whole", A=A),
                  dict(common, label=f"{label} rows", mtx=paths[kind]),
                  dict(common, label=f"{label} multihost", A=A, multihost=True)]
    per_rank = launch.spawn(torch_rank_helpers.run_cases, P, args=(cases, "cpu"))
    out = {}
    for i, case in enumerate(cases):
        ranks = [r[i] for r in per_rank]
        for other in ranks[1:]:
            assert (other["restarts"], other["total_iters"]) == \
                (ranks[0]["restarts"], ranks[0]["total_iters"])
            assert np.array_equal(other["x"], ranks[0]["x"])
        out[case["label"]] = ranks
    return out, paths


@pytest.mark.parametrize("label", list(SOLVES))
@pytest.mark.parametrize("form", ["rows", "multihost"])
def test_per_host_solve_equals_the_whole_matrix_solve(label, form, port_results):
    results, _ = port_results
    whole, got = results[f"{label} whole"], results[f"{label} {form}"]
    assert got[0]["converged"]
    assert (got[0]["restarts"], got[0]["total_iters"]) == (whole[0]["restarts"],
                                                           whole[0]["total_iters"])
    np.testing.assert_array_equal(got[0]["x"], whole[0]["x"])
    # each rank built about its own quarter of the partitioned forms
    for rank in range(P):
        share = got[rank]["partition_local_bytes"] / whole[rank]["partition_local_bytes"]
        assert abs(share * P - 1) <= 0.2 or label == "force-sell", share
    if form == "rows":
        assert all(r["load_seconds"] is not None for r in got)


@pytest.mark.parametrize("label", list(SOLVES))
def test_per_host_solve_matches_jax_and_the_oracle(label, port_results):
    results, paths = port_results
    kind, precond, extra = SOLVES[label]
    A_j = jax_loader.load_matrix(paths[kind])
    A = loader.load_matrix(paths[kind])
    b = A.to_scipy() @ rand_vect(A.n_rows, 42)
    blk = jax_loader.load_matrix_rows(paths[kind], 0, A_j.n_rows)
    cfg = gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec.from_mode("mixed"),
                                precond=precond, jacobi_steps=3, **KW)
    ref = jax_dist.solve_distributed(blk, b, cfg, mesh=Mesh(np.array(jax.devices()[:P]),
                                                            (AXIS,)), **extra)
    got = results[f"{label} rows"][0]
    assert ref.converged and abs(got["restarts"] - ref.restarts) <= 1
    rel = lambda a, c: np.linalg.norm(a - c) / np.linalg.norm(c)
    assert rel(got["x"], np.asarray(ref.x)) <= 1e-6
    if precond == "bilu_jacobi":
        return  # the oracle has no block-Jacobi ILU (tests/test_torch_bilu.py pins it)
    inv_diag = build_jacobi(A, torch.float32).inv_diag.numpy() if precond == "jacobi" else None
    orc = oracle_solve(A.to_scipy().toarray(), b, tol=KW["tol"], rlen=KW["restart_length"],
                       max_restarts=KW["max_restarts"], orth="cgsr", mode="mixed",
                       inv_diag=inv_diag)
    assert orc.converged and abs(got["restarts"] - orc.restarts) <= 1
    assert rel(got["x"], orc.x) <= 1e-5
