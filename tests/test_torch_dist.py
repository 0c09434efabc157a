"""The distributed slice as a whole: ``gmres_tpu_torch.solve_distributed`` on
four gloo ranks (spawned once for the module, on the CPU, through the plain
versions of the kernels) against the JAX package's ``solve_distributed`` on a
four-device CPU mesh, and against the dense numpy oracle
``tests/oracle_gmres.py``.

Held to: every rank the same result; restarts within one of the JAX
package's in every mode, and equal restarts and iterations in ``baseline``
and ``df64`` (fp64 sums in another order; no case here sits on a restart
boundary; the oracle's fp64 cycle stands for df64); x
within 1e-6 of the JAX package's (1e-5 under a restart policy), the
tolerances of ``tests/test_distributed.py``; and the oracle's restarts
within one, x within 1e-6 (fp64 cycle) or 1e-5 (fp32 cycle).

The refusal of distributed exact ILU needs no ranks: it raises before the
first collective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d, poisson_2d
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.parallel.dist_gmres import AXIS
from gmres_tpu.parallel.dist_gmres import solve_distributed as jax_solve_distributed
from gmres_tpu.precond.build import build_jacobi as jax_build_jacobi
from gmres_tpu_torch.parallel import launch
from gmres_tpu_torch.parallel.dist_gmres import run_cases

from oracle_gmres import oracle_solve
from test_torch_halo import neighbour_local, port_csr

P = 4
COMMON = dict(restart_length=15, tol=1e-8, max_restarts=200)
POLICY = dict(orth="cgsr", precond="identity", restart_improvement=1e-2)

# label -> (matrix, mode, config)
CASES = {
    "cgsr-baseline": (poisson_2d, "baseline", dict(orth="cgsr", precond="identity")),
    "cgsr-mixed": (poisson_2d, "mixed", dict(orth="cgsr", precond="identity")),
    "cgs-jacobi": (poisson_2d, "mixed", dict(orth="cgs", precond="jacobi")),
    "ilu-jacobi": (convection_diffusion_2d, "mixed",
                   dict(orth="cgsr", precond="ilu_jacobi", jacobi_steps=3, restart_length=20)),
    "mgs-icwy": (poisson_2d, "mixed", dict(orth="mgs", precond="identity", low_sync_mgs=True)),
    "mgs-sequential": (poisson_2d, "mixed",
                       dict(orth="mgs", precond="identity", low_sync_mgs=False)),
    "mgs-auto-mixed": (poisson_2d, "mixed", dict(orth="mgs", precond="identity")),
    "mgs-auto-baseline": (poisson_2d, "baseline", dict(orth="mgs", precond="identity")),
    "relres": (poisson_2d, "mixed", dict(policy="relres", **POLICY)),
    "repeat": (poisson_2d, "mixed", dict(policy="repeat", **POLICY)),
    "orthloss": (poisson_2d, "mixed", dict(policy="orthloss", **POLICY)),
    "allgather": (poisson_2d, "mixed", dict(orth="cgsr", precond="identity", auto_format=False)),
    "halo-csr": (neighbour_local, "mixed", dict(orth="cgsr", precond="jacobi")),
    # the df64 tier: the cycle on (hi, lo) pairs, its sums over the ranks in
    # fp64 (tests/test_torch_dist_tiers.py holds the other orthogonalizations)
    "df64-cgsr": (poisson_2d, "df64", dict(orth="cgsr", precond="identity")),
    "df64-mgs-auto": (poisson_2d, "df64", dict(orth="mgs", precond="identity")),
}
SIZE = {poisson_2d: 12, convection_diffusion_2d: 10}


def _matrix(make):
    return make(SIZE[make]) if make in SIZE else make()


def _configs(mode, kw):
    kw = {**COMMON, **kw}
    return (gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec.from_mode(mode), **kw),
            gmres_tpu_torch.GmresConfig(precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode),
                                        **kw))


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    return np.asarray(jax_spmv(A, jnp.asarray(x_true)))


@pytest.fixture(scope="module")
def port_results():
    """Every case solved on one spawn of P gloo ranks: label -> per-rank
    results."""
    cases = []
    for label, (make, mode, kw) in CASES.items():
        A = _matrix(make)
        cases.append(dict(label=label, A=port_csr(A), b=_problem(A), cfg=_configs(mode, kw)[1]))
    per_rank = launch.spawn(run_cases, P, args=(cases, "cpu"))
    return {case["label"]: [r[i] for r in per_rank] for i, case in enumerate(cases)}


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("label", list(CASES))
def test_matches_jax_distributed_and_oracle(label, port_results):
    make, mode, kw = CASES[label]
    A = _matrix(make)
    b = _problem(A)
    cj, _ = _configs(mode, kw)
    ranks = port_results[label]
    got = ranks[0]
    for other in ranks[1:]:  # every rank holds the same result
        assert (other["restarts"], other["total_iters"]) == (got["restarts"], got["total_iters"])
        assert np.array_equal(other["x"], got["x"])
    assert got["converged"] and got["x"].shape == (A.n_rows,)
    # each case's matrix is new, so every rank staged its blocks and counts them
    assert all(r["partition_local_bytes"] > 0 for r in ranks)

    mesh = Mesh(np.array(jax.devices()[:P]), (AXIS,))
    ref = jax_solve_distributed(A, b, cj, mesh=mesh)
    assert ref.converged
    assert abs(got["restarts"] - ref.restarts) <= 1
    if mode in ("baseline", "df64"):
        assert (got["restarts"], got["total_iters"]) == (ref.restarts, ref.total_iters)
    x_tol = 1e-5 if "policy" in kw else 1e-6
    assert _rel(got["x"], np.asarray(ref.x)) <= x_tol

    dense = A.to_scipy().toarray()
    inv_diag = (np.asarray(jax_build_jacobi(A, np.float32).inv_diag)
                if kw["precond"] == "jacobi" else None)
    orc = oracle_solve(dense, b, tol=cj.tol, rlen=cj.restart_length,
                       max_restarts=cj.max_restarts, orth=kw["orth"], mode=mode,
                       policy=kw.get("policy", "fixed"), rtol=kw.get("restart_improvement", 0.0),
                       inv_diag=inv_diag, ilu_jacobi_steps=kw.get("jacobi_steps", 0)
                       if kw["precond"] == "ilu_jacobi" else 0)
    assert orc.converged
    assert abs(got["restarts"] - orc.restarts) <= 1
    assert _rel(got["x"], orc.x) <= (1e-6 if mode in ("baseline", "df64") else 1e-5)


def test_dryrun_on_two_ranks():
    # the JAX package's dryrun, ported: a small mixed ILU-Jacobi solve on
    # spawned ranks, converged to x_true on each
    from gmres_tpu_torch.parallel.dist_gmres import dryrun

    results = dryrun(2, device="cpu")
    assert len(results) == 2 and results[0] == results[1]
    assert results[0][2] < 1e-4


def test_halo_csr_case_takes_the_rebased_csr_route():
    from gmres_tpu_torch.parallel.halo import HaloCSR, partition_halo

    assert isinstance(partition_halo(port_csr(neighbour_local()), P), HaloCSR)


@pytest.mark.parametrize("case", ["exact_ilu"])
def test_unported_distributed_options_raise(case):
    # distributed exact ILU stays refused, as in the JAX package; every other
    # option of the JAX package's solve_distributed is ported
    A = poisson_2d(12)
    cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond="ilu")
    with pytest.raises(NotImplementedError, match="distributed exact ILU"):
        gmres_tpu_torch.solve_distributed(port_csr(A), np.ones(A.n_rows), cfg, device="cpu")
