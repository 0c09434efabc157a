"""The port's command lines and sweep runner on the CPU, called in-process
through ``main(argv)``, against the JAX package's: ``cli.solve`` on
synthetic matrices and on an ``.mtx`` file this test writes, its messages
and refusals, and the sweep and findmin round trip of ``tests/test_cli.py``.

b.  Without ``--bpath`` both command lines take b = A x_true with the CSR
product summed row by row in stored-entry order (the port's
``cli.solve.host_spmv`` is the JAX package's sorted ``segment_sum``), so b
has the same bits in both: ``test_rhs_is_bit_equal``.

resNorm and errNorm.  Both are norms of a residual and an error at the
solver's tolerance, taken from x; the two packages' x differ by rounding
(their sums run in other orders), by up to 1e-9 of ||x_true|| when the inner
loop is fp64 and 1e-5 when it is fp32, as ``tests/test_torch_solver.py``
holds the solutions.  So errNorm is held within that bound times
||x_true|| and resNorm within ||A||_F times it; relative to themselves they
differ by up to ~1e-1 in fp32 cycles (a residual at 1e-6 of its scale is
mostly rounding), and by ~1e-8 in fp64 ones.  The restart and iteration
counts are held equal.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from gmres_tpu.cli import solve as jax_cli
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu_torch.cli import solve as port_cli
from gmres_tpu_torch.experiments import findmin, history, sweep
from gmres_tpu_torch.io import mmio
from gmres_tpu_torch.io.rng import rand_vect
from gmres_tpu_torch.io.synth import convection_diffusion_2d, poisson_2d

# the reference's scrape regex (automated.py:33-38), as tests/test_cli.py pins it
SUMMARY_REGEX = r"""
Found solution with rel prec res norm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*) when k = (\d+) and i = (\d+)
  total iterations = (\d+)
  ilu took (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)s; gmres took (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)s
  resNorm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*); errNorm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)
"""
ROUNDING = {"float64": 1e-9, "float32": 1e-5}


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _matrix_file(tmp_path):
    A = poisson_2d(8)
    rp, ci, v = A.numpy_arrays()
    p = tmp_path / "m.mtx"
    mmio.write_coordinate(p, A.n_rows, A.n_cols, A.row_ids.numpy(), ci, v)
    return A, p


@pytest.mark.parametrize("args,inner", [
    (["--synth", "poisson2d:10"], "float32"),                      # the reference's defaults
    (["--synth", "convdiff:16", "--mode", "baseline", "--orth", "cgsr", "--prec", "identity",
      "--tol", "1e-8"], "float64"),
    (["--synth", "convdiff:16", "--prec", "ilu_jacobi", "--jacobi-steps", "3", "--rlen", "12"],
     "float32"),
    (["--synth", "poisson3d:6", "--orth", "cgs", "--prec", "jacobi", "--mode", "single"],
     "float32"),
    (["FILE", "--mode", "baseline", "--prec", "identity", "--rlen", "10"], "float64"),
    (["FILE", "--bpath", "RHS", "--orth", "cgsr", "--prec", "identity", "--rlen", "10"],
     "float32"),
])
def test_solve_cli_matches_gmres_tpu(tmp_path, args, inner):
    A, path = _matrix_file(tmp_path)
    rhs = tmp_path / "b.mtx"
    mmio.write_array(rhs, np.sin(np.arange(A.n_rows)) + 2.0)
    args = [{"FILE": "--Apath", "RHS": str(rhs)}.get(a, a) for a in args]
    if "--Apath" in args:
        args.insert(1, str(path))
    (rj, oj), (rp, op) = (run(m.main, ["--device", "cpu", "--json"] + args)
                          for m in (jax_cli, port_cli))
    assert rj == rp == 0
    lj, lp = oj.splitlines(), op.splitlines()
    assert lp[:4] == lj[:4]  # ||x||, ||b||, ||A|| and the banner, to the digit
    mj, mp = re.search(SUMMARY_REGEX, oj), re.search(SUMMARY_REGEX, op)
    assert mj and mp, op
    assert mp.group(2, 3, 4) == mj.group(2, 3, 4)  # k, i, total iterations
    j, p = json.loads(lj[-1]), json.loads(lp[-1])
    assert (p["converged"], p["aborted"], p["k"], p["i"], p["total_iters"], p["n"], p["nnz"]) == \
        (j["converged"], j["aborted"], j["k"], j["i"], j["total_iters"], j["n"], j["nnz"])
    # ||x_true||; with --bpath x_true is 0 and errNorm is ||x|| itself
    x_norm = j["err_norm"] if "--bpath" in args else np.linalg.norm(rand_vect(p["n"], 42))
    a_norm = float(lj[2].split("= ")[1])
    bound = ROUNDING[inner] * x_norm
    assert abs(p["err_norm"] - j["err_norm"]) <= bound
    assert abs(p["res_norm"] - j["res_norm"]) <= a_norm * bound


@pytest.mark.parametrize("spec", ["poisson2d:10", "convdiff:16", "mesh3d:300"])
def test_rhs_is_bit_equal(spec):
    import jax.numpy as jnp

    from gmres_tpu.cli.solve import make_synth as jax_synth

    A, jA = port_cli.make_synth(spec), jax_synth(spec)
    x = rand_vect(A.n_rows, 42)
    assert port_cli.host_spmv(A, x).tobytes() == np.asarray(jax_spmv(jA, jnp.asarray(x))).tobytes()


def test_solve_cli_reference_output_contract():
    # tests/test_cli.py:test_solve_cli_reference_output_contract, in the port
    rc, out = run(port_cli.main, ["--device", "cpu", "--synth", "poisson2d:12", "--mode",
                                  "baseline", "--orth", "mgs", "--prec", "identity", "--rlen",
                                  "15", "--tol", "1e-6"])
    assert rc == 0
    m = re.search(SUMMARY_REGEX, out)
    assert m, out
    assert int(m.group(2)) == 0 and int(m.group(4)) > 0
    assert "||x|| = " in out and "||A|| = " in out and "Doing Baseline test" in out
    rc, out = run(port_cli.main, ["--device", "cpu", "--synth", "poisson2d:8", "--rlen", "10",
                                  "--prec", "jacobi"])
    assert rc == 0 and "Doing Mixed Precision test" in out


def test_solve_cli_messages():
    for main in (jax_cli.main, port_cli.main):
        assert run(main, ["--device", "cpu"]) == (1, "No value suplied for A\n")
        rc, out = run(main, ["--device", "cpu", "--synth", "poisson2d:8", "--repeat-iter",
                             "--orthloss"])
        assert (rc, out) == (1, "Repeated Iteration Restart cannot be used with OrthLoss "
                                "restart\n")
        rc, out = run(main, ["--device", "cpu", "--synth", "poisson2d:12", "--mode",
                             "baseline", "--prec", "identity", "--rlen", "5", "--tol", "1e-15",
                             "--max-restarts", "2"])
        assert rc == 0 and "Aborting after 10 iterations" in out
        assert "Found solution" not in out


def test_solve_cli_device():
    # the card unless the CPU is asked for; --gpu is the reference's spelling
    # of the card, and without one the default raises as solve does
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the contract is about machines without one")
    for argv in (["--synth", "poisson2d:8"], ["--synth", "poisson2d:8", "--gpu"],
                 ["--synth", "poisson2d:8", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(port_cli.main, argv)
    with pytest.raises(SystemExit):
        run(port_cli.main, ["--synth", "poisson2d:8", "--device", "tpu"])


def test_make_synth_matches_gmres_tpu():
    from gmres_tpu.cli.solve import make_synth as jax_synth

    for spec in ("poisson2d:9", "poisson3d:5", "convdiff:7", "mesh:500", "mesh3d:400",
                 "poisson2d"):
        A, ref = port_cli.make_synth(spec), jax_synth(spec)
        assert (A.n_rows, A.nnz) == (ref.n_rows, ref.nnz)
        assert A.vals.numpy().tobytes() == np.asarray(ref.vals)[:ref.nnz].tobytes()
    with pytest.raises(SystemExit):
        port_cli.make_synth("nope:3")


def test_fmt_is_cout():
    assert [port_cli.fmt(v) for v in (1e-8, 0.000123456789, 30, 2.5e10)] == \
        ["1e-08", "0.000123457", "30", "2.5e+10"]


def _sweep(tmp_path, *extra):
    return run(sweep.main, ["--device", "cpu", "--prec", "identity", "--orth", "mgs",
                            "--no-singleprec", "--no-single", "--out-dir", str(tmp_path),
                            *extra])


def test_sweep_and_findmin(tmp_path):
    # tests/test_cli.py:test_sweep_and_findmin through the port's modules
    rc, _ = _sweep(tmp_path, "poisson2d:10", "10", "0", "1e-6", "42")
    assert rc == 0
    lines = (tmp_path / "history-poisson2d10.csv").read_text().strip().splitlines()
    assert len(lines) == 2  # baseline + mixed
    assert lines[0].startswith("poisson2d10,b,MGS,10,")
    assert lines[1].startswith("poisson2d10,mp,MGS,10,")
    assert [ln.split(",")[7] for ln in lines] == ["cpu", "cpu"]
    rows = [json.loads(ln) for ln in (tmp_path / "history-poisson2d10.jsonl").read_text()
            .splitlines()]
    assert [r["type"] for r in rows] == ["b", "mp"] and rows[0]["device"] == "cpu"
    rc2, out2 = run(findmin.main, ["--plotting-format", "--in-dir", str(tmp_path), "1e-06",
                                   "MGS", "cpu", "identity", "poisson2d10"])
    assert rc2 == 0 and out2.startswith("'poisson2d10': [(")
    # normalised filter spellings select the same rows (1e-6 for 1e-06, mgs for MGS)
    rc3, out3 = run(findmin.main, ["--plotting-format", "--in-dir", str(tmp_path), "1e-6",
                                   "mgs", "cpu", "identity", "poisson2d10"])
    assert rc3 == 0 and out3 == out2
    # the counts of the rows are those of the JAX package's sweep
    from gmres_tpu.experiments import sweep as jax_sweep

    jdir = tmp_path / "jax"
    jdir.mkdir()
    assert run(jax_sweep.main, ["--device", "cpu", "--prec", "identity", "--orth", "mgs",
                                "--no-singleprec", "--no-single", "--out-dir", str(jdir),
                                "poisson2d:10", "10", "0", "1e-6", "42"])[0] == 0
    jrows = history.read_history("poisson2d10", str(jdir))
    prows = history.read_history("poisson2d10", str(tmp_path))
    keys = ("mat", "type", "orth", "rlen", "rtol", "rorth", "tol", "prec", "i", "total_iters")
    assert [[r[k] for k in keys] for r in prows] == [[r[k] for k in keys] for r in jrows]
    assert [r["device"] for r in jrows] == ["cpu", "cpu"]


def test_findmin_with_no_rows_fails(tmp_path):
    assert _sweep(tmp_path, "poisson2d:10", "10", "0", "1e-6", "42")[0] == 0
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc, out = run(findmin.main, ["--in-dir", str(tmp_path), "1e-6", "mgs", "cuda",
                                     "identity", "poisson2d10"])
    assert rc == 1 and out == "" and "no matching history rows" in buf.getvalue()


def test_sweep_comma_lists_and_warmup(tmp_path, monkeypatch):
    # tests/test_cli.py:test_sweep_comma_lists; and --warmup adds one untimed
    # solve per configuration, seeds excluded
    calls = []
    real = sweep.run_one

    def counting(*a, **kw):
        calls.append(kw["warmup"])
        return real(*a, **kw)

    monkeypatch.setattr(sweep, "run_one", counting)
    rc, _ = _sweep(tmp_path, "--no-baseline", "poisson2d:10", "10,12", "0", "1e-6", "42,7")
    assert rc == 0
    lines = (tmp_path / "history-poisson2d10.csv").read_text().strip().splitlines()
    assert len(lines) == 4  # mixed x 2 restart lengths x 2 seeds
    assert calls == [1, 0, 1, 0]


def test_sweep_records_a_failed_run_as_dashes(tmp_path):
    row = sweep.run_one(poisson_2d(6), "p6", "baseline", "mgs", "identity", 5, 0.0, 0.0, 1e-15,
                        2, False, 42, "cpu")
    assert row["type"] == "b" and row["device"] == "cpu"
    assert [row[k] for k in ("i", "total_iters", "res", "err", "ilu", "gmres")] == ["-"] * 6
    A = convection_diffusion_2d(8)
    row = sweep.run_one(A, "c8", "mixed", "cgsr", "ilu_jacobi(3)", 10, 0.0, 0.0, 1e-8, 100,
                        False, 42, "cpu")
    assert row["prec"] == "ilu_jacobi(3)" and row["orth"] == "CGSR" and int(row["i"]) >= 1


def test_sweep_lets_a_raised_error_through(tmp_path, monkeypatch):
    # a failed kernel build or launch raises out of the sweep, where the
    # reference records a crashed run as dashes; the rows run before it are
    # written
    from gmres_tpu_torch.solver import gmres

    real, calls = gmres.solve, []

    def fails_after_two(*a, **kw):
        calls.append(1)
        if len(calls) > 2:  # the mixed configuration's warm-up solve
            raise RuntimeError("gmres_dia_spmv_f32: CUDA error 719 (unspecified launch failure)")
        return real(*a, **kw)

    monkeypatch.setattr(gmres, "solve", fails_after_two)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _sweep(tmp_path, "--warmup", "1", "poisson2d:10", "10", "0", "1e-6", "42")
    rows = history.read_history("poisson2d10", str(tmp_path))
    assert [r["type"] for r in rows] == ["b"] and rows[0]["i"] != "-"
