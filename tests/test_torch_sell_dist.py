"""The per-rank SELL route of ``gmres_tpu_torch.solve_distributed``
(``parallel/dist_gmres.py``) against the JAX package's
``gmres_tpu/parallel/sell_dist.py`` route.

Held to:
- the route and its grid: the JAX package's gate (``auto_format``, an fp32
  inner dtype, at least 64K rows and a pattern DIA refuses; or
  ``force_sell``) and its block height ``sell_rows_per``, equal for every
  size tried;
- the outer residual of a rank's SELL block (``outer_residual`` with a
  ``comm``): x gathered, K5's rank form (its plain twin here), and the two
  sums of squares summed over the ranks: the ranks' rows of r concatenate
  to b - A x within 1e-12 relative, the sums to ||r||^2 and ||x||^2
  within 1e-12 relative;
- solves on four gloo ranks (one spawn, the CPU, the plain versions)
  against the JAX package's ``solve_distributed`` on a four-device CPU
  mesh (its SELL route off the TPU: the Pallas kernels in interpret mode,
  the fp64 outer residual a CSR allgather on the SELL grid): restarts
  within one, x within 1e-6 of its x (1e-5 with a bf16 basis); the
  smallest also against the dense oracle ``tests/oracle_gmres.py``:
  restarts within one, x within 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.parallel.dist_gmres import AXIS
from gmres_tpu.parallel.dist_gmres import solve_distributed as jax_solve_distributed
from gmres_tpu.parallel.sell_dist import sell_rows_per as jax_sell_rows_per
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.ops.cuda.outer_kernel import outer_residual
from gmres_tpu_torch.ops.cuda.sell_kernel import sell_residual_plain
from gmres_tpu_torch.ops.sell import sell_from_csr
from gmres_tpu_torch.parallel import dist_gmres, launch
from gmres_tpu_torch.sparse import csr_from_arrays

import torch_rank_helpers
from oracle_gmres import oracle_solve
from test_torch_bf16_ilu import jax_bf16_ilu  # noqa: F401  (autouse: the JAX numpy ILU path)

P = 4


@pytest.fixture(autouse=True)
def numpy_sell_packer(monkeypatch):
    # the JAX package's numpy SELL packer, which the port is held to
    monkeypatch.setenv("GMRES_TPU_SELL_NUMPY", "1")


def _mesh(n=6000, seed=11):
    return lambda: jax_synth.unstructured_mesh(n, jitter=8, seed=seed)


COMMON = dict(orth="cgsr", precond="identity", restart_length=20, tol=1e-8, max_restarts=300)
# label -> (matrix, precision, config, force_sell)
CASES = {
    "force-mixed": (_mesh(), "mixed", COMMON, True),
    "force-single": (_mesh(), "single", dict(COMMON, tol=1e-6), True),
    "force-jacobi": (_mesh(4000, 7), "mixed", dict(COMMON, precond="jacobi"), True),
    "force-ilu-jacobi": (_mesh(4000, 7), "mixed",
                         dict(COMMON, precond="ilu_jacobi", jacobi_steps=3), True),
    "force-bilu": (_mesh(4000, 7), "mixed",
                   dict(COMMON, precond="bilu_jacobi", jacobi_steps=3), True),
    "force-cb": (_mesh(), "mixed-cb", COMMON, True),
    "force-banded": (lambda: jax_synth.convection_diffusion_2d(40), "mixed", COMMON, True),
    "force-small": (_mesh(1500, 3), "mixed", COMMON, True),
    "auto-64k": (lambda: jax_synth.unstructured_mesh(64 * 1024, run=8), "mixed",
                 dict(COMMON, restart_length=30), False),
}


def _precision(pkg, name):
    if name == "mixed-cb":
        return dataclasses.replace(pkg.PrecisionSpec.from_mode("mixed"), basis="bfloat16")
    return pkg.PrecisionSpec.from_mode(name)


def _configs(name, kw):
    return (gmres_tpu.GmresConfig(precision=_precision(gmres_tpu, name), **kw),
            gmres_tpu_torch.GmresConfig(precision=_precision(gmres_tpu_torch, name), **kw))


def _port_csr(A):
    return csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    return x_true, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


@pytest.fixture(scope="module")
def port_results():
    """Every case on one spawn of P gloo ranks: label -> rank 0's result
    (every rank checked to hold the same)."""
    cases = []
    for label, (make, name, kw, force) in CASES.items():
        A = make()
        cases.append(dict(label=label, A=_port_csr(A), b=_problem(A)[1],
                          cfg=_configs(name, kw)[1], force_sell=force))
    per_rank = launch.spawn(torch_rank_helpers.run_cases, P, args=(cases, "cpu"))
    out = {}
    for i, case in enumerate(cases):
        ranks = [r[i] for r in per_rank]
        for other in ranks[1:]:
            assert (other["restarts"], other["total_iters"]) == \
                (ranks[0]["restarts"], ranks[0]["total_iters"])
            assert np.array_equal(other["x"], ranks[0]["x"])
        out[case["label"]] = ranks[0]
    return out


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("label", list(CASES))
def test_matches_jax_distributed(label, port_results):
    make, name, kw, force = CASES[label]
    A = make()
    x_true, b = _problem(A)
    got = port_results[label]
    ref = jax_solve_distributed(A, b, _configs(name, kw)[0], force_sell=force,
                                mesh=Mesh(np.array(jax.devices()[:P]), (AXIS,)))
    assert ref.converged and got["converged"]
    assert abs(got["restarts"] - ref.restarts) <= 1
    assert _rel(got["x"], np.asarray(ref.x)) <= (1e-5 if name == "mixed-cb" else 1e-6)


def test_small_case_matches_the_oracle(port_results):
    A = CASES["force-small"][0]()
    _, b = _problem(A)
    got = port_results["force-small"]
    orc = oracle_solve(A.to_scipy().toarray(), b, tol=COMMON["tol"],
                       rlen=COMMON["restart_length"], max_restarts=COMMON["max_restarts"],
                       orth="cgsr", mode="mixed")
    assert orc.converged and abs(got["restarts"] - orc.restarts) <= 1
    assert _rel(got["x"], orc.x) <= 1e-5


def _comm(size, rank=0):
    return types.SimpleNamespace(size=size, rank=rank, group=None)


@pytest.mark.parametrize("make,mode,kw,want", [
    (lambda: jax_synth.unstructured_mesh(64 * 1024, run=8), "mixed", {}, True),
    (lambda: jax_synth.unstructured_mesh(64 * 1024, run=8), "mixed-cb", {}, True),
    (lambda: jax_synth.unstructured_mesh(64 * 1024, run=8), "baseline", {}, False),
    (lambda: jax_synth.unstructured_mesh(64 * 1024, run=8), "mixed",
     dict(auto_format=False), False),
    (lambda: jax_synth.unstructured_mesh(60 * 1024, run=8), "mixed", {}, False),
    (lambda: jax_synth.convection_diffusion_2d(256), "mixed", {}, False),
])
def test_route_gate(make, mode, kw, want):
    # the JAX package's gate (gmres_tpu/parallel/dist_gmres.py:633-662)
    A = _port_csr(make())
    cfg = _configs(mode, dict(COMMON, **kw))[1]
    route = dist_gmres._route(A, cfg, _comm(P), multihost=False, force_sell=False)
    assert route.sell == want
    assert route.rows_per == (dist_gmres.sell_rows_per(A.n_rows, P) if want
                               else -(-A.n_rows // P))


@pytest.mark.parametrize("n,p", [(1, 1), (1000, 4), (4096, 4), (4097, 4), (65536, 4),
                                 (1048576, 4), (1048577, 3), (25000, 8)])
def test_sell_grid_matches_jax(n, p):
    assert dist_gmres.sell_rows_per(n, p) == jax_sell_rows_per(n, p)


class _GatherComm:
    """One rank of ``size`` in one process: all_gather hands back the whole
    x; the sums over the ranks are left to the test."""

    def __init__(self, rank, size, x_full):
        self.rank, self.size, self.x_full = rank, size, x_full

    def all_gather(self, x_local):
        return self.x_full

    def all_reduce_sum(self, t):
        return t


@pytest.mark.parametrize("inner", [torch.float32, torch.float64])
def test_outer_residual_of_a_rank_sell_block(inner):
    # the repair: a rank's SELL block has global columns, so its residual
    # needs the gathered x and sums over the ranks
    A = _port_csr(jax_synth.unstructured_mesh(3000, jitter=8, seed=5))
    n, ranks = A.n_rows, 2
    r = dist_gmres.sell_rows_per(n, ranks)
    rng = np.random.default_rng(0)
    x = np.zeros(r * ranks)
    x[:n] = rng.standard_normal(n)
    b = np.zeros(r * ranks)
    b[:n] = rng.standard_normal(n)
    rp, ci, v = A.numpy_arrays()
    parts = []
    for rank in range(ranks):
        lo, hi = rank * r, min((rank + 1) * r, n)
        rows = np.full(r + 1, rp[hi] - rp[lo])
        rows[:hi - lo + 1] = rp[lo:hi + 1] - rp[lo]
        S = sell_from_csr(csr_from_arrays(rows, ci[rp[lo]:rp[hi]], v[rp[lo]:rp[hi]],
                                          n_cols=r * ranks))
        comm = _GatherComm(rank, ranks, torch.from_numpy(x))
        parts.append(outer_residual(S, torch.from_numpy(b[rank * r:(rank + 1) * r]),
                                    torch.from_numpy(x[rank * r:(rank + 1) * r]), inner, comm))
    r_all = torch.cat([p[0] for p in parts]).numpy()[:n]
    want = b[:n] - A.to_scipy() @ x[:n]
    assert _rel(r_all, want) <= 1e-12
    r_ss = sum(float(p[1]) for p in parts)
    x_ss = sum(float(p[2]) for p in parts)
    # ||r'||^2 of r rounded to the inner dtype
    assert abs(r_ss - want @ want) <= (1e-6 if inner == torch.float32 else 1e-12) * (want @ want)
    assert abs(x_ss - x @ x) <= 1e-12 * (x @ x)


def test_rank_residual_form_plain_twin():
    # K5's rank form: b and r the block's rows, x the gathered vector,
    # ||x||^2 over x[x_off : x_off + rows]
    A = _port_csr(jax_synth.unstructured_mesh(2048, jitter=4, seed=2))
    S = sell_from_csr(A)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4096))
    b = torch.from_numpy(rng.standard_normal(2048))
    S2 = dataclasses.replace(S, n_cols=4096)
    r, r_ss, x_ss = sell_residual_plain(S2.vals, S2.cols, S2.slice_ptr, b, x, torch.float64,
                                        x_off=1024)
    want = b.numpy() - A.to_scipy() @ x.numpy()[:2048]
    np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=1e-12)
    own = x.numpy()[1024:3072]
    assert abs(float(x_ss) - own @ own) <= 1e-12 * (own @ own)
    assert abs(float(r_ss) - want @ want) <= 1e-12 * (want @ want)
