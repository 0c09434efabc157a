"""Every precision tier on the distributed path: ``gmres_tpu_torch.
solve_distributed`` on four gloo ranks (one spawn for the module, on the
CPU, through the plain versions of the kernels) in the compressed-basis,
bf16 and df64 tiers, against the JAX package's ``solve_distributed`` on a
four-device CPU mesh, as ``tests/test_cb_basis.py:60-76`` and
``tests/test_df64_mode.py:125-160`` run it.

Held to, each within the bound stated at its table:
- every rank the same result;
- the compressed basis (bf16 under fp32, fp32 under fp64): the JAX
  package's restarts within one (equal under fp64), x within 1e-6 of its x
  (1e-10 under fp64) and within 1e-4 of x_true;
- the bf16 inner tier (identity, Jacobi, bf16 ILU-Jacobi; CGSR and ICWY
  MGS; the halo and the allgather routes): restarts within one, the
  backward error within tol; and a solve that stalls neither stalls nor
  escalates, in both packages (no stall window on the distributed path);
- df64 (CGSR, CGS, sequential and ICWY MGS): the JAX package's restarts and
  iterations, x within 1e-12 of its x.  A Comm that sums the ranks' df64
  partials as their hi parts (fp32, ``torch_rank_helpers.HiPartsComm``)
  moves the count or x beyond these bounds: that is what the fp64 pair
  sums protect.

The ranks move bf16 vectors (halo edges, the allgather, bf16 partials) as
their bytes, viewed as uint8: gloo refuses int16, and a detour through fp32
would double the bytes.
"""

import dataclasses

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
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu_torch.config import use_lowsync_mgs
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.parallel import launch
from gmres_tpu_torch.parallel.comm import _wire

import torch_rank_helpers
from test_torch_bf16_ilu import jax_bf16_ilu  # noqa: F401  (autouse: the JAX bf16 ILU build)

P = 4


def _precision(pkg, tier):
    base = {"mixed-cb": "mixed", "baseline-cb": "baseline"}.get(tier)
    if base is not None:
        return dataclasses.replace(pkg.PrecisionSpec.from_mode(base),
                                   basis="bfloat16" if base == "mixed" else "float32")
    if tier == "bf16":
        return pkg.PrecisionSpec("float64", "bfloat16", "bfloat16")
    return pkg.PrecisionSpec.from_mode(tier)


def _scaled_convdiff():
    """convdiff(16, beta=1) scaled by 10^U(0, 2) on both sides: a bf16 solve
    floors there (tests/test_torch_bf16.py)."""
    A0 = jax_synth.convection_diffusion_2d(16, beta=1.0)
    n = A0.n_rows
    scale = 10.0 ** np.random.default_rng(3).uniform(0, 2.0, size=n)
    rp = np.asarray(A0.row_ptr)
    ci = np.asarray(A0.col_idx)[: A0.nnz]
    v = np.asarray(A0.vals)[: A0.nnz]
    rows = np.repeat(np.arange(n), np.diff(rp))
    return jax_csr_from_coo(rows, ci, v * scale[rows] * scale[ci], n_rows=n)


CB = dict(precond="jacobi", restart_length=15, tol=1e-8, max_restarts=300)
BF16 = dict(restart_length=20, tol=1e-6, max_restarts=200)
DF64 = dict(precond="jacobi", restart_length=12, tol=1e-11, max_restarts=100)
# full GMRES with one CGS pass: the df64 cycle reaches 1e-14 in one cycle
# only while its sums over the ranks keep fp64
FULL = dict(orth="cgs", precond="identity", restart_length=64, tol=1e-14, max_restarts=10)

# label -> (matrix, tier, config)
CASES = {
    "mixed-cb-cgsr": (lambda: jax_synth.convection_diffusion_2d(12), "mixed-cb",
                      dict(orth="cgsr", **CB)),
    "mixed-cb-cgs": (lambda: jax_synth.convection_diffusion_2d(12), "mixed-cb",
                     dict(orth="cgs", **CB)),
    "mixed-cb-icwy": (lambda: jax_synth.convection_diffusion_2d(12), "mixed-cb",
                      dict(orth="mgs", **CB)),
    "baseline-cb-cgsr": (lambda: jax_synth.convection_diffusion_2d(12), "baseline-cb",
                         dict(orth="cgsr", **CB)),
    "baseline-cb-mgs": (lambda: jax_synth.convection_diffusion_2d(12), "baseline-cb",
                        dict(orth="mgs", **CB)),
    "bf16-identity": (lambda: jax_synth.poisson_2d(12), "bf16",
                      dict(orth="cgsr", precond="identity", **BF16)),
    "bf16-jacobi": (lambda: jax_synth.poisson_2d(12), "bf16",
                    dict(orth="cgsr", precond="jacobi", **BF16)),
    "bf16-ilu-jacobi": (lambda: jax_synth.convection_diffusion_2d(12), "bf16",
                        dict(orth="cgsr", precond="ilu_jacobi", jacobi_steps=3, **BF16)),
    "bf16-icwy": (lambda: jax_synth.poisson_2d(12), "bf16",
                  dict(orth="mgs", precond="jacobi", **BF16)),
    "bf16-allgather": (lambda: jax_synth.poisson_2d(12), "bf16",
                       dict(orth="cgsr", precond="jacobi", auto_format=False, **BF16)),
    "df64-cgsr": (lambda: jax_synth.convection_diffusion_2d(16, beta=1.0), "df64",
                  dict(orth="cgsr", **DF64)),
    "df64-cgs": (lambda: jax_synth.convection_diffusion_2d(16, beta=1.0), "df64",
                 dict(orth="cgs", **DF64)),
    "df64-mgs-sequential": (lambda: jax_synth.convection_diffusion_2d(16, beta=1.0), "df64",
                            dict(orth="mgs", low_sync_mgs=False, **DF64)),
    "df64-mgs-icwy": (lambda: jax_synth.convection_diffusion_2d(16, beta=1.0), "df64",
                      dict(orth="mgs", low_sync_mgs=True, **DF64)),
    "df64-full": (lambda: jax_synth.poisson_2d(8), "df64", FULL),
}
# the cases run again with the ranks' df64 sums taken as their hi parts
HI_PARTS = ("df64-full",)
# a bf16 solve that floors: on one device the port escalates after 16
# restarts
STALL = (_scaled_convdiff, "bf16",
         dict(orth="cgsr", precond="identity", restart_length=20, tol=1e-8, max_restarts=20))


def _matrix(label):
    return (CASES[label] if label in CASES else STALL)[0]()


def _configs(tier, kw):
    return (gmres_tpu.GmresConfig(precision=_precision(gmres_tpu, tier), **kw),
            gmres_tpu_torch.GmresConfig(precision=_precision(gmres_tpu_torch, tier), **kw))


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    return x_true, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


def _port_csr(A):
    return csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)


@pytest.fixture(scope="module")
def port_results():
    """Every case solved on one spawn of P gloo ranks: label -> per-rank
    results (the hi-parts runs under "<label>/hi", the stall under
    "stall")."""
    cases = []
    runs = [(label, label, False) for label in CASES]
    runs += [(f"{label}/hi", label, True) for label in HI_PARTS] + [("stall", "stall", False)]
    for key, label, hi in runs:
        _, tier, kw = CASES.get(label, STALL)
        A = _matrix(label)
        cases.append(dict(label=key, A=_port_csr(A), b=_problem(A)[1],
                          cfg=_configs(tier, kw)[1], hi_parts=hi))
    per_rank = launch.spawn(torch_rank_helpers.run_cases, P, args=(cases, "cpu"))
    out = {case["label"]: [r[i] for r in per_rank] for i, case in enumerate(cases)}
    for key, ranks in out.items():
        for other in ranks[1:]:  # every rank holds the same result
            assert (other["restarts"], other["total_iters"]) == \
                (ranks[0]["restarts"], ranks[0]["total_iters"]), key
            assert np.array_equal(other["x"], ranks[0]["x"]), key
    return {key: ranks[0] for key, ranks in out.items()}


def _jax(label):
    _, tier, kw = CASES.get(label, STALL)
    A = _matrix(label)
    x_true, b = _problem(A)
    mesh = Mesh(np.array(jax.devices()[:P]), (AXIS,))
    return jax_solve_distributed(A, b, _configs(tier, kw)[0], mesh=mesh), A, x_true, b


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _backward_error(A, x, b):
    r = b - A.to_scipy() @ x
    return np.linalg.norm(r) / (np.linalg.norm(b) + np.linalg.norm(np.asarray(A.vals))
                                * np.linalg.norm(x))


@pytest.mark.parametrize("label", [k for k in CASES if CASES[k][1].endswith("-cb")])
def test_compressed_basis_matches_jax_distributed(label, port_results):
    got = port_results[label]
    ref, _, x_true, _ = _jax(label)
    assert ref.converged and got["converged"]
    fp64 = label.startswith("baseline")
    if fp64:
        assert (got["restarts"], got["total_iters"]) == (ref.restarts, ref.total_iters)
    assert abs(got["restarts"] - ref.restarts) <= 1
    assert _rel(got["x"], np.asarray(ref.x)) <= (1e-10 if fp64 else 1e-6)
    assert np.linalg.norm(got["x"] - x_true) < 1e-4


@pytest.mark.parametrize("label", [k for k in CASES if k.startswith("bf16")])
def test_bf16_tier_matches_jax_distributed(label, port_results):
    got = port_results[label]
    ref, A, _, b = _jax(label)
    assert ref.converged and got["converged"]
    assert abs(got["restarts"] - ref.restarts) <= 1, (got["restarts"], ref.restarts)
    assert _backward_error(A, got["x"], b) <= CASES[label][2]["tol"]


def test_distributed_bf16_solve_never_escalates(port_results):
    # the JAX package passes no stall window to its distributed restart loop
    # (gmres_tpu/parallel/dist_gmres.py:795-799): a bf16 solve that floors
    # runs to max_restarts unescalated.  The port's single-device solve of
    # the same problem escalates
    got = port_results["stall"]
    ref, A, _, b = _jax("stall")
    assert not ref.converged and not ref.stalled and not ref.escalated
    assert not got["converged"] and got["aborted"]
    assert got["restarts"] == ref.restarts == STALL[2]["max_restarts"]
    single = gmres_tpu_torch.solve(_port_csr(A), b, _configs(*STALL[1:])[1], device="cpu")
    assert single.escalated and single.restarts == STALL[2]["max_restarts"]


@pytest.mark.parametrize("label", [k for k in CASES if k.startswith("df64")])
def test_df64_tier_matches_jax_distributed(label, port_results):
    got = port_results[label]
    ref, _, x_true, _ = _jax(label)
    assert ref.converged and got["converged"]
    assert (got["restarts"], got["total_iters"]) == (ref.restarts, ref.total_iters)
    assert _rel(got["x"], np.asarray(ref.x)) <= 1e-12
    assert _rel(got["x"], x_true) <= 1e-6


def test_df64_sums_of_hi_parts_fail_the_bounds(port_results):
    # the same full-GMRES solve with each rank's fp64 partial rounded to
    # fp32 before the sum over the ranks: its one pass of CGS leaves the
    # basis fp32-orthogonal, the cycle stops short of 1e-14 and a second one
    # is needed, so the count moves off the JAX package's (which the solve
    # with fp64 sums keeps)
    hi = port_results["df64-full/hi"]
    ref = _jax("df64-full")[0]
    assert ref.restarts == 1 and port_results["df64-full"]["restarts"] == 1
    assert (hi["restarts"], hi["total_iters"]) != (ref.restarts, ref.total_iters)


def test_distributed_low_sync_rule_covers_every_tier():
    # low_sync_mgs=None on a distributed cycle: ICWY on CUDA in every tier;
    # on the CPU the JAX package's rules (ICWY unless the cycle is native
    # fp64, gmres_tpu/solver/gmres.py:204-208; ICWY for every df64 cycle,
    # :325-328), a compressed basis taking its inner dtype's rule
    want_cpu = {"mixed-cb": True, "baseline-cb": False, "bf16": True, "df64": True,
                "mixed": True, "baseline": False}
    for tier, cpu in want_cpu.items():
        cfg = gmres_tpu_torch.GmresConfig(precision=_precision(gmres_tpu_torch, tier),
                                          orth="mgs")
        assert use_lowsync_mgs(cfg, "cpu", distributed=True) is cpu, tier
        assert use_lowsync_mgs(cfg, "cuda", distributed=True) is True, tier


def test_bf16_moves_between_ranks_as_its_bytes():
    x = torch.tensor([1.0, -2.5, 3.0e-3], dtype=torch.bfloat16)
    wire = _wire(x)
    assert wire.dtype == torch.uint8 and wire.numel() == 2 * x.numel()
    assert torch.equal(wire.view(torch.bfloat16), x)
    assert _wire(x.float()).dtype == torch.float32
