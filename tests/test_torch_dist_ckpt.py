"""The sharded checkpoint of ``gmres_tpu_torch.solve_distributed``
(``parallel/dist_gmres.py:_dist_ckpt_hooks``, ``solver/gmres.py:
drive_restarts``'s three hooks) against the JAX package's
``_dist_ckpt_hooks``.

Held to:
- the consensus rules, on the same headers, equal to the JAX package's
  ``consensus`` hook: the lowest restart is adopted with its counts and
  policy state (each rank keeping its own x), a missing file on any rank
  starts every rank afresh; non-contiguous owned shards are refused with
  its message;
- on four gloo ranks (one spawn, the CPU): a solve cut at 4 restarts and
  resumed equals the uninterrupted solve bit for bit (counts and x), in
  mixed and in df64; a rank whose file was removed sends every rank back
  to the start (the uninterrupted solve's bits); ranks whose files are
  two restarts apart adopt the lower and converge (backward error within
  tol); each rank's file ``<path>.p<rank>`` is read by the JAX package's
  ``checkpoint.load`` (the same format);
- the JAX package's ``solve_distributed`` cut and resumed with
  ``checkpoint=`` on a four-device CPU mesh: restarts within one (equal in
  df64), x within 1e-6 (1e-10 in df64); the dense oracle
  ``tests/oracle_gmres.py``: restarts within one, x within 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.parallel import dist_gmres as jax_dist
from gmres_tpu.parallel.dist_gmres import AXIS
from gmres_tpu.solver.policies import PolicyState as JaxPolicyState
from gmres_tpu.utils import checkpoint as jax_ckpt
from gmres_tpu.utils.checkpoint import CheckpointSpec as JaxCheckpointSpec
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.parallel import dist_gmres, launch
from gmres_tpu_torch.solver.policies import PolicyState
from gmres_tpu_torch.utils.checkpoint import CheckpointSpec

import torch_rank_helpers
from oracle_gmres import oracle_solve

P = 4
KW = dict(orth="cgsr", precond="identity", restart_length=10, tol=1e-10, max_restarts=200)
CUT = 4


def _A():
    return jax_synth.convection_diffusion_2d(12, beta=1.0)


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    return x_true, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


def _cfgs(mode, **kw):
    kw = {**KW, **kw}
    return (gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec.from_mode(mode), **kw),
            gmres_tpu_torch.GmresConfig(precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode),
                                        **kw))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist_ckpt"))


@pytest.fixture(scope="module")
def port_results(ckpt_dir):
    A = _A()
    pA, b = csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols), _problem(A)[1]
    path = lambda name: os.path.join(ckpt_dir, name)
    cases = []
    for mode in ("mixed", "df64"):
        cfg = _cfgs(mode)[1]
        spec = CheckpointSpec(path(mode), every=2)
        cases += [dict(label=f"full {mode}", cfg=cfg),
                  dict(label=f"cut {mode}", cfg=cfg.with_(max_restarts=CUT), checkpoint=spec),
                  dict(label=f"resume {mode}", cfg=cfg, checkpoint=spec)]
    cfg = _cfgs("mixed")[1]
    # rank 2 loses its file: every rank starts afresh
    gone = CheckpointSpec(path("gone"), every=1)
    cases += [dict(label="cut gone", cfg=cfg.with_(max_restarts=3), checkpoint=gone),
              dict(label="resume gone", cfg=cfg, checkpoint=gone,
                   files=[("remove", gone.path + ".p2", 2)])]
    # rank 0's file two restarts behind the others': all adopt the lower
    apart = CheckpointSpec(path("apart"), every=1)
    cases += [dict(label="cut apart 3", cfg=cfg.with_(max_restarts=3), checkpoint=apart),
              dict(label="cut apart 5", cfg=cfg.with_(max_restarts=5), checkpoint=apart,
                   files=[("copy", apart.path + ".p0", path("apart.saved"), 0)]),
              dict(label="resume apart", cfg=cfg, checkpoint=apart,
                   files=[("copy", path("apart.saved"), apart.path + ".p0", 0)])]
    cases = [dict(c, A=pA, b=b) for c in cases]
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


@pytest.mark.parametrize("mode", ["mixed", "df64"])
def test_resume_equals_the_uninterrupted_solve(mode, port_results):
    cut, res, full = (port_results[f"{k} {mode}"] for k in ("cut", "resume", "full"))
    assert cut["aborted"] and cut["restarts"] == CUT
    assert res["converged"] and full["converged"]
    assert (res["restarts"], res["total_iters"]) == (full["restarts"], full["total_iters"])
    assert np.array_equal(res["x"], full["x"])


@pytest.mark.parametrize("mode", ["mixed", "df64"])
def test_resume_matches_jax_distributed(mode, port_results, tmp_path):
    A = _A()
    _, b = _problem(A)
    cfg = _cfgs(mode)[0]
    mesh = Mesh(np.array(jax.devices()[:P]), (AXIS,))
    spec = JaxCheckpointSpec(str(tmp_path / "jax.ckpt"), every=2)
    cut = jax_dist.solve_distributed(A, b, cfg.with_(max_restarts=CUT), mesh=mesh,
                                     checkpoint=spec)
    ref = jax_dist.solve_distributed(A, b, cfg, mesh=mesh, checkpoint=spec)
    got = port_results[f"resume {mode}"]
    assert cut.aborted and ref.converged
    assert abs(got["restarts"] - ref.restarts) <= 1
    if mode == "df64":
        assert (got["restarts"], got["total_iters"]) == (ref.restarts, ref.total_iters)
    rel = np.linalg.norm(got["x"] - np.asarray(ref.x)) / np.linalg.norm(np.asarray(ref.x))
    assert rel <= (1e-10 if mode == "df64" else 1e-6)


def test_resume_matches_the_oracle(port_results):
    A = _A()
    _, b = _problem(A)
    got = port_results["resume mixed"]
    orc = oracle_solve(A.to_scipy().toarray(), b, tol=KW["tol"], rlen=KW["restart_length"],
                       max_restarts=KW["max_restarts"], orth="cgsr", mode="mixed")
    assert orc.converged and abs(got["restarts"] - orc.restarts) <= 1
    assert np.linalg.norm(got["x"] - orc.x) / np.linalg.norm(orc.x) <= 1e-5


def test_a_missing_file_restarts_every_rank(port_results):
    got, full = port_results["resume gone"], port_results["full mixed"]
    assert (got["restarts"], got["total_iters"]) == (full["restarts"], full["total_iters"])
    assert np.array_equal(got["x"], full["x"])


def test_ranks_apart_adopt_the_lowest_restart(port_results):
    A = _A()
    _, b = _problem(A)
    got = port_results["resume apart"]
    assert port_results["cut apart 5"]["restarts"] == 5 and got["converged"]
    x = got["x"]
    backward = np.linalg.norm(b - A.to_scipy() @ x) / (
        np.linalg.norm(b) + np.linalg.norm(np.asarray(A.vals)) * np.linalg.norm(x))
    assert backward <= KW["tol"]


def test_rank_files_keep_the_checkpoint_format(port_results, ckpt_dir):
    A = _A()
    r = -(-A.n_rows // P)
    full = port_results["full mixed"]["x"]
    for rank in range(P):
        x, i, iters, _ = jax_ckpt.load(os.path.join(ckpt_dir, f"mixed.p{rank}"))
        assert x.shape == (r,) and x.dtype == np.float64
        # the last save: at the restart before convergence, a multiple of every=2
        assert i % 2 == 0 and 0 < i <= port_results["resume mixed"]["restarts"]
        assert np.all(np.isfinite(x)) and np.abs(x - full[rank * r:(rank + 1) * r]).max() < 1e-3


def _jax_pstate(ps):
    return JaxPolicyState(is_first=jnp.asarray(ps.is_first),
                          second_restart_length=jnp.asarray(np.int32(ps.second_restart_length)),
                          restart_tol=jnp.asarray(ps.restart_tol, jnp.float64))


HEADERS = {
    "agree": [(6, 60, False, 10, 0.5)] * 4,
    "apart": [(4, 40, False, 10, 0.25), (6, 60, False, 10, 0.5), (6, 60, False, 10, 0.5),
              (8, 75, True, 7, 0.125)],
    "missing": [(6, 60, False, 10, 0.5), None, (6, 60, False, 10, 0.5), (6, 60, False, 10, 0.5)],
    "none": [None] * 4,
}


@pytest.mark.parametrize("case", list(HEADERS))
def test_consensus_matches_jax(case, recwarn):
    headers = HEADERS[case]
    xs = [np.full(3, float(rank)) for rank in range(P)]
    states = [None if h is None else (xs[k], h[0], h[1], PolicyState(h[2], h[3], h[4]), False)
              for k, h in enumerate(headers)]
    got = torch_rank_helpers.run_threaded(
        lambda rank, ex: dist_gmres.ckpt_consensus(states[rank], ex), P)
    mesh = Mesh(np.array(jax.devices()[:P]), (AXIS,))
    shard0 = NamedSharding(mesh, PartitionSpec(AXIS))

    def jax_rank(rank, ex):
        hooks = jax_dist._dist_ckpt_hooks(JaxCheckpointSpec("unused"), mesh, shard0, False, 3,
                                          list(range(P)), exchange=ex)
        s = states[rank]
        return hooks[3](None if s is None else (s[0], s[1], s[2], _jax_pstate(s[3])))

    want = torch_rank_helpers.run_threaded(jax_rank, P)
    for rank in range(P):
        if want[rank] is None:
            assert got[rank] is None
            continue
        x, i, iters, ps, stalled = got[rank]
        wx, wi, witers, wps = want[rank]
        assert x is xs[rank] and wx is xs[rank]  # each rank keeps its own x
        assert (i, iters, stalled) == (wi, witers, False)
        assert ps == PolicyState(bool(wps.is_first), int(wps.second_restart_length),
                                 float(wps.restart_tol))


def test_noncontiguous_shards_are_refused():
    mesh = Mesh(np.array(jax.devices()[:P]), (AXIS,))
    with pytest.raises(ValueError) as jax_err:
        jax_dist._dist_ckpt_hooks(JaxCheckpointSpec("unused"), mesh,
                                  NamedSharding(mesh, PartitionSpec(AXIS)), False, 3, [0, 2])
    with pytest.raises(ValueError) as port_err:
        dist_gmres._dist_ckpt_hooks(CheckpointSpec("unused"), 0, [0, 2], None)
    assert str(port_err.value) == str(jax_err.value)
    spec = dist_gmres._dist_ckpt_hooks(CheckpointSpec("run.ckpt", every=3), 2, [2], None)[0]
    assert dataclasses.astuple(spec) == ("run.ckpt.p2", 3)
