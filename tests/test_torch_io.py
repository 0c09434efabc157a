"""MatrixMarket I/O, the loaders and the configuration builders of the port
against ``gmres_tpu``'s, bit for bit: ``mmio.read``, ``load_matrix`` and
``load_vector`` on every case of ``tests/test_loader.py`` (files this test
writes itself), the writers' bytes, ``synth.poisson_3d`` and
``GmresConfig.from_flags``."""

import dataclasses

import numpy as np
import pytest

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io import loader as jax_loader
from gmres_tpu.io import mmio as jax_mmio
from gmres_tpu.io import synth as jax_synth
from gmres_tpu_torch.io import loader, mmio, synth

# tests/test_loader.py's files, and a few more of the formats mmio reads
FILES = {
    "general_missing_diag": "%%MatrixMarket matrix coordinate real general\n"
                            "3 3 3\n1 2 5.0\n2 1 -2.0\n3 3 7.0\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 4\n1 1 2.0\n2 1 -1.0\n3 2 -1.0\n3 3 2.0\n",
    "duplicate_diagonal": "%%MatrixMarket matrix coordinate real general\n"
                          "2 2 3\n1 1 1.0\n1 1 9.0\n2 2 3.0\n",
    "duplicate_offdiagonal": "%%MatrixMarket matrix coordinate real general\n"
                             "2 2 2\n1 2 2.0\n1 2 3.0\n",
    "symmetric_duplicates": "%%MatrixMarket matrix coordinate real symmetric\n"
                            "3 3 5\n2 1 1.5\n2 1 -0.5\n3 3 4.0\n3 3 8.0\n3 1 0.25\n",
    "nonsquare": "%%MatrixMarket matrix coordinate real general\n2 3 1\n1 1 1.0\n",
    "complex": "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1.0 0.0\n",
    "integer": "%%MatrixMarket matrix coordinate integer general\n2 2 2\n1 1 3\n2 2 4\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n3 3 2\n1 3\n2 2\n",
    "comments": "%%MatrixMarket matrix coordinate real general\n% a comment\n%another\n"
                "2 2 2\n1 1 1.5\n2 2 2.5\n",
    "empty": "%%MatrixMarket matrix coordinate real general\n3 3 0\n",
    "vector_coordinate": "%%MatrixMarket matrix coordinate real general\n"
                         "4 1 2\n2 1 5.0\n4 1 -1.0\n",
    "array_general": "%%MatrixMarket matrix array real general\n3 2\n1\n2\n3\n4\n5\n6\n",
    "array_symmetric": "%%MatrixMarket matrix array real symmetric\n3 3\n1\n2\n3\n4\n5\n6\n",
    "bad_banner": "not a banner\n1 1 1\n",
    "bad_size": "%%MatrixMarket matrix coordinate real general\n3 3\n1 1 1.0\n",
    "short_data": "%%MatrixMarket matrix coordinate real general\n3 3 2\n1 1 1.0\n",
}


def _outcome(fn, *args, **kw):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*args, **kw), None
    except (ValueError, mmio.MMIOError, jax_mmio.MMIOError) as e:
        return None, (type(e).__name__, str(e))


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


def _write(tmp_path, name):
    p = tmp_path / f"{name}.mtx"
    p.write_text(FILES[name])
    return p


@pytest.mark.parametrize("name", sorted(FILES))
def test_read_matches_gmres_tpu(tmp_path, name):
    p = _write(tmp_path, name)
    got, gerr = _outcome(mmio.read, p)
    want, werr = _outcome(jax_mmio.read, p)
    assert gerr == werr
    if werr is None:
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
        if want[0].is_coordinate:
            assert [_bits(a) for a in got[1]] == [_bits(a) for a in want[1]]
        else:
            assert _bits(got[1]) == _bits(want[1])
        assert dataclasses.asdict(mmio.read_header(p)) == dataclasses.asdict(want[0])


@pytest.mark.parametrize("name", sorted(FILES))
def test_load_matrix_matches_gmres_tpu(tmp_path, name):
    p = _write(tmp_path, name)
    got, gerr = _outcome(loader.load_matrix, p)
    want, werr = _outcome(jax_loader.load_matrix, p)
    assert gerr == werr
    if werr is None:
        nnz = want.nnz
        assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols, nnz)
        assert np.array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
        assert np.array_equal(got.col_idx.numpy(), np.asarray(want.col_idx)[:nnz])
        assert _bits(got.vals.numpy()) == _bits(np.asarray(want.vals)[:nnz])


@pytest.mark.parametrize("name,col", [("vector_coordinate", 0), ("vector_coordinate", 1),
                                      ("array_general", 0), ("array_general", 1),
                                      ("array_general", 2), ("general_missing_diag", 2)])
def test_load_vector_matches_gmres_tpu(tmp_path, name, col):
    p = _write(tmp_path, name)
    got, gerr = _outcome(loader.load_vector, p, col=col)
    want, werr = _outcome(jax_loader.load_vector, p, col=col)
    assert gerr == werr
    if werr is None:
        assert _bits(got) == _bits(want)


@pytest.mark.parametrize("rows,cols,vals,n,symmetric", [
    ([0, 0, 1], [0, 0, 1], [1.0, 9.0, 3.0], 2, False),       # the last diagonal wins
    ([0, 0], [1, 1], [2.0, 3.0], 2, False),                  # duplicates kept, file order
    ([1, 2, 2, 0], [0, 1, 1, 0], [-1.0, 0.5, 0.25, 4.0], 3, True),
    ([], [], [], 4, False),                                  # only the diagonal placeholders
])
def test_assemble_reference_csr_matches_gmres_tpu(rows, cols, vals, n, symmetric):
    got = loader.assemble_reference_csr(rows, cols, vals, n, symmetric)
    want = jax_loader.assemble_reference_csr(rows, cols, vals, n, symmetric)
    assert [_bits(a) for a in got] == [_bits(a) for a in want]


def test_random_file_round_trip_matches_gmres_tpu(tmp_path):
    # a seeded general file with duplicates, missing diagonals and values
    # that need all 17 digits; written by each package's writer, the bytes agree
    rng = np.random.default_rng(5)
    n, nnz = 200, 1500
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz) * 10.0 ** rng.integers(-8, 8, nnz)
    p, q = tmp_path / "port.mtx", tmp_path / "jax.mtx"
    mmio.write_coordinate(p, n, n, rows, cols, vals, comment="seeded\ntwo lines")
    jax_mmio.write_coordinate(q, n, n, rows, cols, vals, comment="seeded\ntwo lines")
    assert p.read_bytes() == q.read_bytes()
    got, want = loader.load_matrix(p), jax_loader.load_matrix(q)
    assert _bits(got.vals.numpy()) == _bits(np.asarray(want.vals)[:want.nnz])
    assert np.array_equal(got.col_idx.numpy(), np.asarray(want.col_idx)[:want.nnz])
    # the values survive the text exactly
    _, (r2, c2, v2) = mmio.read(p)
    assert np.array_equal(r2, rows) and np.array_equal(c2, cols) and _bits(v2) == _bits(vals)
    x = rng.standard_normal((n, 2))
    mmio.write_array(p, x)
    jax_mmio.write_array(q, x)
    assert p.read_bytes() == q.read_bytes()
    for col in (0, 1):
        assert _bits(loader.load_vector(p, col=col)) == _bits(x[:, col])
    mmio.write_array(p, x[:, 0])  # a 1-D vector is written as one column
    jax_mmio.write_array(q, x[:, 0])
    assert p.read_bytes() == q.read_bytes()


def test_synth_matrix_round_trips_through_a_file(tmp_path):
    # what chip_smoke.py does at convdiff@1M: write the generated matrix and
    # read it back to the same CSR arrays
    A = synth.convection_diffusion_2d(24, beta=2.0)
    rp, ci, v = A.numpy_arrays()
    p = tmp_path / "cd.mtx"
    mmio.write_coordinate(p, A.n_rows, A.n_cols, A.row_ids.numpy(), ci, v)
    B = gmres_tpu_torch.load_matrix(p)
    assert np.array_equal(B.row_ptr.numpy(), rp) and np.array_equal(B.col_idx.numpy(), ci)
    assert _bits(B.vals.numpy()) == _bits(v)


@pytest.mark.parametrize("args", [(6,), (5, 4, 3), (1,), (2, 1, 7)])
def test_poisson_3d_bit_identical(args):
    A, ref = synth.poisson_3d(*args), jax_synth.poisson_3d(*args)
    nnz = ref.nnz
    assert (A.n_rows, A.nnz) == (ref.n_rows, nnz)
    assert np.array_equal(A.row_ptr.numpy(), np.asarray(ref.row_ptr))
    assert np.array_equal(A.col_idx.numpy(), np.asarray(ref.col_idx)[:nnz])
    assert _bits(A.vals.numpy()) == _bits(np.asarray(ref.vals)[:nnz])


@pytest.mark.parametrize("flags", [
    {},
    dict(mode="baseline", orth="CGSR", prec="identity", rlen=50, tol=1e-8),
    dict(rtol=0.5),
    dict(rtol=1e-2, repeat_iter=True, mode="single"),
    dict(rtol=1e-3, orthloss=True, prec="ilu_jacobi", jacobi_steps=3),
    dict(mode="df64", max_restarts=7, nan_fallback=True),
    dict(mode="single-prec", orth="cgs", prec="jacobi", low_sync_mgs=True),
])
def test_from_flags_matches_gmres_tpu(flags):
    got = gmres_tpu_torch.GmresConfig.from_flags(**flags)
    want = gmres_tpu.GmresConfig.from_flags(**flags)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    w.pop("use_pallas")
    assert g == w


def test_from_flags_refuses_repeat_with_orthloss():
    messages = []
    for cls in (gmres_tpu_torch.GmresConfig, gmres_tpu.GmresConfig):
        with pytest.raises(ValueError) as e:
            cls.from_flags(rtol=0.1, repeat_iter=True, orthloss=True)
        messages.append(str(e.value))
    assert messages[0] == messages[1] == \
        "Repeated Iteration Restart cannot be used with OrthLoss restart"
