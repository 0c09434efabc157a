"""The ``--dist`` command lines of the port (``cli/solve.py``,
``experiments/sweep.py``) against the JAX package's, and against the
port's own single-device command lines.

Held to:
- ``cli.solve --dist`` in this process (a one-rank gloo group of its own,
  ``launch.command_group``, destroyed after): the single-device command's
  stdout block, its lines byte for byte but for the numbers a rounding
  moves: the times, and the residual norms and ``errNorm`` of a solve
  whose x differs by rounding (errNorm within 1e-5 ||x_true||, the bound
  of ``tests/test_torch_cli.py`` for an fp32 loop); the counts
  (k, i, total iterations) equal; the JAX package's ``--dist``
  counts (k, i, total iterations) within one restart, its summary block
  parsed by the reference's regex;
- ``cli.solve --dist`` and ``sweep --dist`` on four gloo ranks (one spawn):
  rank 0 prints the block of the in-process run with its counts, the other
  ranks print nothing; the sweep's rows, written by rank 0 alone, carry
  the counts of the single-device sweep's rows and of the JAX package's
  ``--dist`` sweep within one restart.
"""

import contextlib
import io
import re

import pytest

from gmres_tpu.cli import solve as jax_cli
from gmres_tpu.experiments import sweep as jax_sweep
from gmres_tpu_torch.cli import solve as port_cli
from gmres_tpu_torch.experiments import history, sweep
from gmres_tpu_torch.parallel import launch

import torch_rank_helpers
from test_torch_cli import SUMMARY_REGEX

P = 4
SOLVES = {
    "mixed cgsr": ["--synth", "convdiff:16", "--orth", "cgsr", "--prec", "identity",
                   "--rlen", "20", "--tol", "1e-8"],
    "baseline jacobi": ["--synth", "poisson2d:12", "--mode", "baseline", "--orth", "cgsr",
                        "--prec", "jacobi", "--rlen", "15", "--tol", "1e-9"],
    "mixed ilu_jacobi": ["--synth", "convdiff:16", "--prec", "ilu_jacobi", "--jacobi-steps", "3",
                         "--rlen", "12"],
}
SWEEP = ["--device", "cpu", "--no-singleprec", "--no-single", "--orth", "cgsr",
         "--prec", "identity", "--warmup", "0", "poisson2d:12", "15", "0", "1e-8"]


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _comparable(out):
    """The block's lines without the numbers a rounding moves."""
    return [line for line in out.splitlines()
            if not line.startswith(("Found solution", "  ilu took", "  resNorm"))]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dist_sweep"))
    runs = [("gmres_tpu_torch.cli.solve", ["--device", "cpu", "--dist", *argv])
            for argv in SOLVES.values()]
    runs.append(("gmres_tpu_torch.experiments.sweep", ["--dist", "--out-dir", out_dir, *SWEEP]))
    per_rank = launch.spawn(torch_rank_helpers.run_mains, P, args=(runs,))
    return per_rank, out_dir


@pytest.mark.parametrize("label", list(SOLVES))
def test_dist_solve_prints_the_single_device_block(label):
    argv = ["--device", "cpu", *SOLVES[label]]
    (rs, single), (rd, dist_out) = run(port_cli.main, argv), run(port_cli.main, ["--dist", *argv])
    assert rs == rd == 0
    assert _comparable(dist_out) == _comparable(single)
    m, ms = re.search(SUMMARY_REGEX, dist_out), re.search(SUMMARY_REGEX, single)
    assert m and ms
    assert m.group(2, 3, 4) == ms.group(2, 3, 4)  # k, i, total iterations
    x_norm = float(single.splitlines()[0].split("= ")[1])
    assert abs(float(m.group(8)) - float(ms.group(8))) <= 1e-5 * x_norm


@pytest.mark.parametrize("label", list(SOLVES))
def test_dist_solve_matches_jax_dist(label):
    argv = ["--device", "cpu", "--dist", *SOLVES[label]]
    (rj, oj), (rp, op) = run(jax_cli.main, argv), run(port_cli.main, argv)
    assert rj == rp == 0
    assert op.splitlines()[:4] == oj.splitlines()[:4]  # ||x||, ||b||, ||A||, the banner
    mj, mp = re.search(SUMMARY_REGEX, oj), re.search(SUMMARY_REGEX, op)
    assert mj and mp
    assert mp.group(2) == mj.group(2)
    assert abs(int(mp.group(3)) - int(mj.group(3))) <= 1
    assert abs(int(mp.group(4)) - int(mj.group(4))) <= int(SOLVES[label][
        SOLVES[label].index("--rlen") + 1])


@pytest.mark.parametrize("label", list(SOLVES))
def test_dist_solve_on_ranks_prints_on_rank_zero(label, rank_runs):
    per_rank, _ = rank_runs
    i = list(SOLVES).index(label)
    rc, out = per_rank[0][i]
    _, here = run(port_cli.main, ["--device", "cpu", "--dist", *SOLVES[label]])
    assert rc == 0 and re.search(SUMMARY_REGEX, out)
    m, mh = re.search(SUMMARY_REGEX, out), re.search(SUMMARY_REGEX, here)
    assert out.splitlines()[:4] == here.splitlines()[:4]
    assert abs(int(m.group(3)) - int(mh.group(3))) <= 1
    assert all(r[i] == (0, "") for r in per_rank[1:])


def test_dist_sweep_on_ranks_writes_the_single_device_rows(rank_runs, tmp_path):
    per_rank, out_dir = rank_runs
    assert all(r[-1][0] == 0 for r in per_rank) and all(r[-1][1] == "" for r in per_rank[1:])
    rows = history.read_history("poisson2d12", out_dir)
    assert run(sweep.main, ["--out-dir", str(tmp_path), *SWEEP])[0] == 0
    single = history.read_history("poisson2d12", str(tmp_path))
    assert [r["type"] for r in rows] == [r["type"] for r in single] == ["b", "mp"]
    for got, want in zip(rows, single):
        assert abs(int(got["i"]) - int(want["i"])) <= 1
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_argv = ["--dist", "--out-dir", str(jax_dir), *SWEEP]
    assert run(jax_sweep.main, jax_argv)[0] == 0
    for got, want in zip(rows, history.read_history("poisson2d12", str(jax_dir))):
        assert abs(int(got["i"]) - int(want["i"])) <= 1


def test_dist_sweep_in_process_matches_the_single_device_sweep(tmp_path):
    (tmp_path / "d").mkdir()
    (tmp_path / "s").mkdir()
    assert run(sweep.main, ["--dist", "--out-dir", str(tmp_path / "d"), *SWEEP])[0] == 0
    assert run(sweep.main, ["--out-dir", str(tmp_path / "s"), *SWEEP])[0] == 0
    got, want = (history.read_history("poisson2d12", str(tmp_path / d)) for d in "ds")
    assert [(r["type"], r["i"], r["total_iters"]) for r in got] == \
        [(r["type"], r["i"], r["total_iters"]) for r in want]
