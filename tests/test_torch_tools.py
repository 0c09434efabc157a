"""The port's tools on the CPU: ``utils/profiling.py``'s spans (off, a
call's spans, their nesting, and their clock against the profiler's in
``trace``'s Chrome trace) and its trace written on the CPU; ``experiments/analysis.py`` against the JAX package's
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


def _solve_spans(batched: bool = False):
    """The spans of one CPU call on convection_diffusion_2d(8), and its
    results: 2 restarts of 10 steps, then the converged check."""
    import gmres_tpu_torch
    from gmres_tpu_torch.io.synth import convection_diffusion_2d

    A = convection_diffusion_2d(8)
    cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond="identity", restart_length=10,
                                      max_restarts=20)
    b = np.ones(A.n_rows)
    with profiling.recording() as spans:
        if batched:
            results = gmres_tpu_torch.solve_batched(A, np.stack([b, 2 * b + 1, -b]), cfg,
                                                    record_history=True, device="cpu")
        else:
            results = [gmres_tpu_torch.solve(A, b, cfg, record_history=True, device="cpu")]
    return spans, results


def _named(spans, name):
    return [i for i, s in enumerate(spans) if s.name == name]


def test_span_is_a_shared_no_op_while_recording_is_off():
    off = profiling.span("step", k=3)
    assert off is profiling.span("cycle") and off is profiling.span("solve", lanes=8)
    with off as inside:
        assert inside is None
    with profiling.recording() as spans:
        with profiling.span("solve", lanes=1) as rec:
            with profiling.span("step", k=0):
                pass
        assert rec is spans[0] and spans[1].parent == 0 and spans[1].attrs == {"k": 0}
    assert [s.name for s in spans] == ["solve", "step"]
    with profiling.span("cycle", i=0):
        pass
    assert len(spans) == 2
    assert all(s.end_ns >= s.start_ns for s in spans)


@pytest.mark.parametrize("batched", [False, True])
def test_a_call_gives_its_spans(batched):
    spans, results = _solve_spans(batched)
    assert {s.call for s in spans} == {0}
    (top,) = _named(spans, "solve")
    assert top == 0 and spans[0].attrs == {"entry": "solve_batched" if batched else "solve",
                                           "lanes": len(results)}
    (prepare,) = _named(spans, "solve.prepare")
    assert spans[prepare].parent == 0
    cycles = _named(spans, "cycle")
    # every cycle run, the converged check included, is one history row
    assert all(len(r.history) == len(cycles) for r in results)
    assert [spans[c].attrs["i"] for c in cycles] == list(range(len(cycles)))
    assert all(spans[c].parent == 0 for c in cycles)
    steps = _named(spans, "step")
    # a batched call's lanes step together: its loop runs the longest lane
    assert len(steps) == max(r.total_iters for r in results) == 20
    for c in cycles:
        ks = [spans[s].attrs["k"] for s in steps if spans[s].parent == c]
        assert ks == list(range(len(ks)))
    assert sum(spans[s].parent in cycles for s in steps) == len(steps)
    # one host read a cycle
    reads = _named(spans, "cycle.read")
    assert len(reads) == len(cycles) and {spans[r].parent for r in reads} == set(cycles)


def test_step_children_lie_within_their_step():
    spans, _ = _solve_spans()
    children = {}
    for s in spans:
        if s.parent is not None and spans[s.parent].name == "step":
            children.setdefault(s.parent, []).append(s)
    assert len(children) == 20
    for step, kids in children.items():
        names = {k.name for k in kids}
        assert {"step.spmv", "step.orth", "step.givens"} <= names <= {
            "step.spmv", "step.precond", "step.orth", "step.givens"}
        for k in kids:
            assert spans[step].start_ns <= k.start_ns <= k.end_ns <= spans[step].end_ns


def test_stage_and_precond_spans():
    import gmres_tpu_torch
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.precond.build import build_preconditioner

    A = convection_diffusion_2d(16)
    cfg = gmres_tpu_torch.GmresConfig(precond="ilu")
    with profiling.recording() as spans:
        gmres_tpu_torch.stage(A, cfg, device="cpu")
        build_preconditioner(A, cfg).to("cpu")
    names = [s.name for s in spans]
    assert names[:3] == ["stage", "stage.pack", "stage.upload"]
    assert {"precond.build", "precond.factor", "precond.levels", "precond.upload"} <= set(names)
    build = names.index("precond.build")
    assert spans[names.index("precond.factor")].parent == build
    # three calls: stage, the build, the upload
    assert len({s.call for s in spans}) == 3


def test_trace_holds_the_spans_on_the_profilers_clock(tmp_path):
    """Each span of the Chrome trace contains whole the profiler's records
    of the torch operators that started inside it."""
    import gmres_tpu_torch
    from gmres_tpu_torch.io.synth import convection_diffusion_2d

    A = convection_diffusion_2d(8)
    cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond="identity", restart_length=10,
                                      max_restarts=20)
    with profiling.trace(str(tmp_path)):
        gmres_tpu_torch.solve(A, np.ones(A.n_rows), cfg, device="cpu")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert len([s for s in spans if s["name"] == "step"]) == 20 and ops
    assert len({s["pid"] for s in spans}) == 1 and spans[0]["pid"] not in {o["pid"] for o in ops}
    (solve,) = [s for s in spans if s["name"] == "solve"]
    slack = 1.0  # microseconds: the trace rounds to nanoseconds, the clocks read apart
    assert all(solve["ts"] - slack <= o["ts"] and o["ts"] + o["dur"] <= solve["ts"]
               + solve["dur"] + slack for o in ops)
    for s in spans:
        a, b = s["ts"], s["ts"] + s["dur"]
        inside = [o for o in ops if a <= o["ts"] <= b]
        assert all(o["ts"] + o["dur"] <= b + slack for o in inside), s
        if s["name"] in ("step.spmv", "step.orth", "step.givens", "cycle.residual"):
            assert inside, s


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
