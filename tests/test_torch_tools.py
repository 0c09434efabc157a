"""The port's tools on the CPU: ``utils/profiling.py`` held to the
expectations of ``tests/test_aux.py::test_profiling_utils`` and its trace
written on the CPU; ``experiments/analysis.py`` against the JAX package's
functions on the same history files (``tests/test_analysis.py``'s); and
``cli/bench_kernels.py --device cpu`` at a tiny size, its JSON keys those of
the JAX package's benchmark where the operation exists."""

import json
import os

import numpy as np
import pytest

from gmres_tpu.experiments import analysis as jax_analysis
from gmres_tpu_torch.experiments import analysis
from gmres_tpu_torch.utils import profiling

from test_analysis import make_history


def test_profiling_utils():
    t = profiling.PhaseTimers()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert "a" in t.as_dict() and t.as_dict()["a"] >= 0

    class R:
        total_iters = 100
        restarts = 10
        converged = True
        solve_seconds = 2.0
        prec_seconds = 0.5

    m = profiling.solve_metrics(R(), nnz=1000)
    assert m["spmv_nnz_per_s"] == 100 * 1000 / 2.0
    from gmres_tpu.utils.profiling import solve_metrics as jax_metrics

    assert m == jax_metrics(R(), nnz=1000)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import gmres_tpu_torch
    from gmres_tpu_torch.io.synth import convection_diffusion_2d

    A = convection_diffusion_2d(8)
    cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond="identity", restart_length=10,
                                      max_restarts=2)
    with profiling.trace(str(tmp_path)) as prof:
        gmres_tpu_torch.solve(A, np.ones(A.n_rows), cfg, device="cpu")
    path = tmp_path / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mv" for e in events)
    assert any(e.key == "aten::dot" for e in prof.key_averages())


def test_seconds_per_call_on_the_cpu():
    calls = []
    t = profiling.seconds_per_call(lambda: calls.append(1), 5, "cpu")
    assert len(calls) == 6 and t >= 0


@pytest.mark.parametrize("mode", ["mp", "b"])
def test_analysis_matches_jax(tmp_path, mode):
    mats = make_history(tmp_path)
    args = (mats, "1e-06", "MGS", "tpu", "identity", str(tmp_path))
    t, tj = analysis.best_timings(*args), jax_analysis.best_timings(*args)
    assert t == tj
    assert analysis.speedups(t, mode) == jax_analysis.speedups(tj, mode)
    assert analysis.latex_timing_table(t) == jax_analysis.latex_timing_table(tj)


def test_analysis_main_and_plot(tmp_path, capsys):
    mats = make_history(tmp_path)
    argv = ["--in-dir", str(tmp_path), "--latex", "1e-06", "MGS", "tpu", "identity", *mats]
    assert analysis.main(argv) == 0
    out = capsys.readouterr().out
    assert jax_analysis.main(argv) == 0
    assert out == capsys.readouterr().out and "geometric mean" in out
    png = tmp_path / "s.png"
    t = analysis.best_timings(mats, "1e-06", "MGS", "tpu", "identity", str(tmp_path))
    assert analysis.plot_speedups(t, "mp", str(png)) > 1.0
    assert png.stat().st_size > 1000


def test_analysis_plot_names_matplotlib_where_it_is_missing(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    mats = make_history(tmp_path)
    t = analysis.best_timings(mats, "1e-06", "MGS", "tpu", "identity", str(tmp_path))
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        analysis.plot_speedups(t, "mp", str(tmp_path / "s.png"))


def test_matrix_properties_match_jax(tmp_path, monkeypatch):
    from gmres_tpu_torch.io import mmio
    from gmres_tpu_torch.io.synth import convection_diffusion_2d

    A = convection_diffusion_2d(6)
    rp, ci, v = A.numpy_arrays()
    mmio.write_coordinate(str(tmp_path / "cd6.mtx"), A.n_rows, A.n_cols, A.row_ids.numpy(),
                          ci[:A.nnz], v[:A.nnz])
    monkeypatch.setenv("MTXDIR", str(tmp_path))
    got = analysis.matrix_properties(["cd6"], condest_iters=200, device="cpu")
    want = jax_analysis.matrix_properties(["cd6"], condest_iters=200)
    assert [(r["mat"], r["n"], r["nnz"], r["bandwidth"]) for r in got] == \
        [(r["mat"], r["n"], r["nnz"], r["bandwidth"]) for r in want]
    np.testing.assert_allclose(got[0]["cond2"], want[0]["cond2"], rtol=1e-6)


def test_bench_kernels_keys_match_jax(capsys):
    from gmres_tpu.cli import bench_kernels as jax_bench
    from gmres_tpu_torch.cli import bench_kernels

    argv = ["--synth", "convdiff:16", "--trials", "2", "--device", "cpu", "--json"]
    assert jax_bench.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench_kernels.main([*argv, "--lanes", "3"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # not carried: the strict-XLA fp64 dot (the port's dot is the strict
    # one); not on the CPU: torch.sparse's bf16 CSR product
    missing = set(ref) - set(got)
    assert missing == {"dot_f64_strict", "spmv_csr_bf16"}, missing
    for key in set(ref) & set(got):
        assert set(ref[key]) <= set(got[key]), key
    assert {"spmv_dia_lanes3_f32", "spmv_dia_lanes3_f64", "spmv_sell_f32", "cgsr2_pallas_f32",
            "cgsr2_pallas_cb_bf16V"} <= set(got)
    assert got["spmv_csr_f64"]["library"] is True
    assert all(v["seconds"] > 0 for v in got.values())


def test_bench_kernels_defaults_to_the_card():
    import torch

    from gmres_tpu_torch.cli import bench_kernels

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the contract is about machines without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_kernels.main(["--synth", "convdiff:8", "--trials", "1"])
