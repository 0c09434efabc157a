"""Restarted GMRES(m) on PyTorch, for one CUDA device or the CPU.

The semantics are those of ``gmres_tpu.solver.gmres`` on its CPU branch
(the reference's ``gmres_baseline`` / ``gmres_singleUpdate``,
``gmres.cpp:24-245``):

- each restart cycle computes the true residual ``r = b - A_out x`` in the
  outer dtype, demotes it to the inner dtype as the start vector ``w0`` and
  takes ``||w0||`` and ``||x||`` (``gmres_tpu/solver/gmres.py:489-504``);
  convergence is tested against ``||b|| + ||A||_F ||x||`` with ``||A||_F``
  from the inner-dtype values, as the reference does;
- the Arnoldi/Givens loop runs in the inner dtype and the solution
  increment is promoted to the outer dtype before it is added
  (``gmres.cpp:276-290``).

How it runs on the card.  The inner loop is a Python ``for k in
range(steps)`` that never reads a value back to the host: no ``.item()``
and no ``if`` on a tensor; the happy-breakdown guard is a ``torch.where``,
the triangular solve is bounded by the device-side ``kdim``, and a restart
policy's trigger is a device-side ``trig_k`` that cuts the cycle after the
loop, as the JAX package does on the TPU (``gmres_tpu/solver/gmres.py:
156-165, 282-298``).  So the loop only enqueues work.  The host reads once
per cycle: one ``.tolist()`` of the cycle's residual scalars together with
the previous cycle's length and final |s(k+1)|, and one more read after
the last cycle of a solve that aborts at ``max_restarts`` (and one at each
checkpoint).  Under REPEAT after the first cycle, the first cycle's length
is known from that read and is the loop's bound.  The hot operations run
on hand-written kernels: the SpMV (K1 on DIA operators, K5 on sliced-ELL
ones), the basis sweeps (K2, K3, K2x2; K7 for sequential MGS), the outer
residual (K1 or K5 in residual mode) and the solution update (K4).  x is
updated in place.  Each layer of a call is a span (``utils/profiling.py``:
``solve``, ``cycle``, ``step``, ``step.givens`` and the rest), one shared
no-op unless the caller is recording.

The df64 tier (``PrecisionSpec.df64_inner``, mode ``"df64"``) carries the
basis and the work vectors of the Arnoldi loop as (hi, lo) fp32 pairs
(``ops/df64.py``), while H, Q, the Givens and policy scalars and x stay
fp64 (``gmres_tpu/solver/gmres.py:301-402``): its SpMV on a DIA operator is
K8, its sweeps K9-K11, its update K4's pair mode; the outer residual stays
native fp64 on K1 or K5.  Every cycle shares the Givens and policy tail
(``_inner_cycle``); what differs is the basis (``_NativeBasis``,
``_PairBasis``, and a batched solve's lanes of native bases,
``solver/batched.py``).

Operators are staged as in the JAX package: DIA when the pattern is banded
enough, else SELL, else CSR.  The JAX package packs SELL only on the TPU
and from n = 128K rows; those gates were the TPU's, and the port packs SELL
at every size on both devices.

Preconditioners are built on the host from the CSR matrix
(``precond/build.py``).  The ILU family needs the CSR structure: for a
staged DIA or SELL operator, build M with ``build_preconditioner(csr, cfg)``
and pass it as ``M=``; without it ``solve`` raises ``TypeError``, as the
JAX package does.

``nan_fallback``: a non-baseline solve that diverges is solved again in
uniform fp64 from the caller's matrix with a newly built preconditioner
(``gmres_tpu/solver/gmres.py:1199-1215``).  ``checkpoint=``
(``utils/checkpoint.py``) saves x, the restart count, the iteration count
and the policy state every ``every`` restarts and resumes from the file.

The compressed basis (``PrecisionSpec.basis``) stores V narrower than the
inner dtype (bf16 under fp32, fp32 under fp64) while w, H, the Givens
rotations and every reduction stay in the inner dtype
(``gmres_tpu/solver/gmres.py:173-179``): the sweeps take the kernels'
mixed dtype forms, and the solution update sums in the dtype that jnp
gives (y, V).  The bf16 inner tier runs the whole cycle in bf16; a solve
that stalls (no 10% gain of the relative residual in 6 restarts, at tol <
1e-5 with ``bf16_escalation``) continues in fp32 from its iterate
(``gmres_tpu/solver/gmres.py:1158-1197``; ``GmresResult.stalled``,
``escalated``).  The JAX package tests for the stall after a chunk of up to
``host_sync_every`` cycles and escalates from the chunk's last iterate; the
port reads every cycle, so it escalates from the iterate of the cycle that
stalled.

Not ported, because they exist for the TPU only: the padding of n to the
Pallas block size (and of the preconditioner with it), the double-float
staging of the outer operator and of x (the H100 runs the outer phase in
native fp64) and the staging cache.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gmres_tpu_torch.config import GmresConfig, PrecisionSpec, RestartPolicy, use_lowsync_mgs
from gmres_tpu_torch.ops import df64
from gmres_tpu_torch.ops.blas import all_reduce, nrm2
from gmres_tpu_torch.ops.cuda._build import acc_dtype
from gmres_tpu_torch.ops.cuda.orth_kernel import gram
from gmres_tpu_torch.ops.cuda.outer_kernel import basis_axpy, basis_axpy_pair, outer_residual
from gmres_tpu_torch.ops.dia import DF64Dia, DIAMatrix, from_csr
from gmres_tpu_torch.ops.givens import accumulate_rotation, rotg
from gmres_tpu_torch.ops.orth import mgs_lowsync_step, orthonormalize_step
from gmres_tpu_torch.ops.reorder import permute_symmetric, rcm_permutation
from gmres_tpu_torch.ops.sell import sell_from_csr
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.ops.tri import trsv_upper_padded
from gmres_tpu_torch.precond.apply import typesafe_apply
from gmres_tpu_torch.precond.build import (
    build_preconditioner,
    optimize_precond_format,
    sell_pack_factors,
)
from gmres_tpu_torch.solver.policies import (
    PolicyState,
    cycle_steps,
    cycle_threshold,
    initial_policy_state,
    next_state,
    orthloss_step,
    residual_policy,
    with_first_length,
)
from gmres_tpu_torch.sparse import CSRMatrix
from gmres_tpu_torch.utils import checkpoint as ckpt
from gmres_tpu_torch.utils.profiling import span

_f64 = torch.float64
# values between two lanes' rotation products Q in a batched solve (512
# bytes of fp32)
_Q_ALIGN = 128


@dataclasses.dataclass
class CycleInfo:
    """Per-restart scalars, read to the host once per cycle."""

    converged0: bool             # check_initial convergence test
    diverged: bool               # non-finite residual or start-vector norm
    r_norm: float                # unpreconditioned residual norm
    beta: float                  # preconditioned residual norm
    rel_initial: float           # r_norm / (||b|| + ||A||_F ||x||)
    prec_rel0: float             # beta / ||M^{-1} b||
    pstate: PolicyState
    # (k_final, |s(k+1)| at the cycle's end) as one fp64 (2,) tensor on the
    # device, read with the next cycle's scalars; None when the inner loop
    # did not run
    tail: torch.Tensor | None = None
    # the previous cycle's (k_final, |s(k+1)|), read with this cycle's scalars
    prev_tail: tuple | None = None


@dataclasses.dataclass
class GmresResult:
    x: torch.Tensor
    converged: bool
    aborted: bool
    total_iters: int
    restarts: int                 # the reference's `i` at termination
    final_k: int                  # 0 when converged at check_initial
    rel_prec_res: float           # beta/||M^{-1}b|| at the converged check
    # the JAX package's fields for the true fp64 ||b - A x|| and ||x - x_true||:
    # neither package's solve sets them (callers such as cli/solve.py compute both)
    residual_norm: float | None = None
    error_norm: float | None = None
    prec_seconds: float = 0.0
    solve_seconds: float = 0.0
    setup_seconds: float = 0.0
    history: list | None = None   # per-cycle (i, k, rel_initial, prec_rel0, ...)
    diverged: bool = False
    fellback_to_fp64: bool = False  # diverged, then solved again in uniform fp64
    stalled: bool = False         # no progress for a window of restarts (bf16 inner)
    escalated: bool = False       # a bf16 inner loop continued in fp32
    # a distributed solve's bytes of this rank's operator and preconditioner
    # blocks (``parallel/dist_gmres.py``); None on a single device
    partition_local_bytes: int | None = None


class _NativeBasis:
    """The Krylov basis of a cycle: V of shape (m+1, n) stored in the basis
    dtype (the inner dtype, or narrower under ``PrecisionSpec.basis``),
    swept by K2/K3 (CGS, CGSR), K7 (sequential MGS) or K2x2 and K3 (ICWY
    MGS, with its coupling matrix L in the accumulation dtype,
    ``gmres_tpu/solver/gmres.py:209,222``); w and the scalars stay in the
    inner dtype, and each new row is rounded to the basis dtype only where
    it is stored."""

    def __init__(self, cfg: GmresConfig, A_in, M, w0: torch.Tensor, beta: torch.Tensor,
                 comm=None, V: torch.Tensor | None = None):
        self.cfg, self.A_in, self.M, self.comm = cfg, A_in, M, comm
        self.dtype = cfg.precision.inner_dtype
        m, dev = cfg.m, w0.device
        # V: storage given by the caller (a batched solve's lane of its bases)
        self.V = (torch.zeros((m + 1, w0.shape[0]), dtype=cfg.precision.basis_dtype, device=dev)
                  if V is None else V)
        self.V[0] = torch.where(beta != 0, w0 / beta, torch.zeros_like(w0))
        self.v_next = None  # v_{k+1} in the inner dtype, before it is stored
        self.lowsync = use_lowsync_mgs(cfg, dev.type, distributed=comm is not None)
        self.L = (torch.zeros((m + 1, m + 1), dtype=acc_dtype(self.dtype), device=dev)
                  if self.lowsync else None)

    def step(self, k: int, Q: torch.Tensor):
        """Arnoldi step k: w = M^{-1} A v_k, then ``orthonormalize``."""
        with span("step.spmv"):
            v = spmv(self.A_in, self.V[k], self.comm)
        with span("step.precond"):
            w = typesafe_apply(self.M, v, self.comm)
        return self.orthonormalize(k, w, Q)

    def orthonormalize(self, k: int, w: torch.Tensor, Q: torch.Tensor):
        """w orthogonalized against rows 0..k and normalized into row k+1.
        Returns (column k of H under the rotations Q, ||w||)."""
        V, cfg, comm = self.V, self.cfg, self.comm
        with span("step.orth"):
            if self.lowsync:
                h_col, w, ss, self.L = mgs_lowsync_step(V, k, w, self.L, comm)
                h_next = torch.sqrt(ss)
            else:
                h_col, w, h_next = orthonormalize_step(cfg.orth.value, V, k, w, cfg.orth_steps,
                                                       comm)
            # the reference divides unconditionally (Orthogonalization.hpp:59);
            # a zero h(k+1,k) gives a zero vector instead of NaNs
            self.v_next = torch.where(h_next != 0, w / h_next, torch.zeros_like(w))
            V[k + 1] = self.v_next
        with span("step.givens"):
            return _rotate(Q, h_col, h_next, k), h_next

    def orthloss(self, S: torch.Tensor, k: int, loss_sq: torch.Tensor) -> torch.Tensor:
        """A step of the loss recurrence on <v_j, v_{k+1}> for j <= k: K2
        over rows 0..k against v_{k+1} in the inner dtype, as the JAX
        package sweeps it (``gmres_tpu/solver/gmres.py:250,265``), not the
        stored row."""
        u = all_reduce(gram(self.V, self.v_next, k + 1), self.comm)
        return orthloss_step(S, k, u, loss_sq)

    def update(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return basis_axpy(x, self.V, y)


class _PairBasis:
    """The df64 tier's basis: (Vh, Vl) fp32 pairs of shape (m+1, n), swept
    by K9-K11, with fp64 scalars (``gmres_tpu/solver/gmres.py:301-402``).
    A new row is w times the split fp64 reciprocal of its norm, as in the
    JAX package.  With ``comm`` the rows are the rank's and each sweep's
    fp64 sum is summed over the ranks (``ops/df64.py``)."""

    dtype = _f64

    def __init__(self, cfg: GmresConfig, A_in, M, w0h, w0l, beta: torch.Tensor, comm=None):
        self.cfg, self.A_in, self.M, self.comm = cfg, A_in, M, comm
        m, dev = cfg.m, w0h.device
        self.Vh = torch.zeros((m + 1, w0h.shape[0]), dtype=torch.float32, device=dev)
        self.Vl = torch.zeros_like(self.Vh)
        self._store(0, w0h, w0l, beta)
        self.lowsync = use_lowsync_mgs(cfg, dev.type, distributed=comm is not None)
        self.L = torch.zeros((m + 1, m + 1), dtype=_f64, device=dev) if self.lowsync else None

    def _store(self, j: int, wh, wl, norm: torch.Tensor) -> None:
        inv = torch.where(norm != 0, 1.0 / norm, torch.zeros_like(norm))
        self.Vh[j], self.Vl[j] = df64.df_scale(wh, wl, *df64.split_f64(inv))

    def step(self, k: int, Q: torch.Tensor):
        cfg, Vh, Vl, comm = self.cfg, self.Vh, self.Vl, self.comm
        with span("step.spmv"):
            vh, vl = df64.spmv_df64_pair(self.A_in, Vh[k], Vl[k], comm)
        with span("step.precond"):
            wh, wl = df64.typesafe_apply_df64(self.M, vh, vl, comm)
        with span("step.orth"):
            if self.lowsync:
                h_col, wh, wl, ss, self.L = df64.df_mgs_lowsync_step(Vh, Vl, k, wh, wl, self.L,
                                                                     comm)
                h_next = torch.sqrt(ss)
            else:
                h_col, wh, wl, h_next = df64.df_orthonormalize_step(cfg.orth.value, Vh, Vl, k,
                                                                     wh, wl, cfg.orth_steps, comm)
            self._store(k + 1, wh, wl, h_next)
        with span("step.givens"):
            return _rotate(Q, h_col, h_next, k), h_next

    def orthloss(self, S: torch.Tensor, k: int, loss_sq: torch.Tensor) -> torch.Tensor:
        u = df64.df_gram(self.Vh, self.Vl, self.Vh[k + 1], self.Vl[k + 1], k + 1, self.comm)
        return orthloss_step(S, k, u, loss_sq)

    def update(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return basis_axpy_pair(x, self.Vh, self.Vl, y)


def _rotate(Q: torch.Tensor, h_col: torch.Tensor, h_next: torch.Tensor, k: int):
    """Column k of H, h(k+1,k) = ``h_next`` included, with all k previous
    rotations applied at once (rows > k of Q are still identity;
    ``gmres.cpp:106-110``)."""
    h_col[k + 1] = h_next
    return torch.mv(Q, h_col)


def _identity_rotations(lanes: tuple, m: int, dt: torch.dtype, dev) -> torch.Tensor:
    """Q = I of size m+1, for each lane.  Each lane's Q starts _Q_ALIGN
    values after the previous lane's, so that its ``torch.mv`` reads it as
    a single cycle reads its own."""
    if not lanes:
        return torch.eye(m + 1, dtype=dt, device=dev)
    width = -(-(m + 1) ** 2 // _Q_ALIGN) * _Q_ALIGN
    Q = torch.zeros((*lanes, width), dtype=dt, device=dev)[..., :(m + 1) ** 2].view(
        *lanes, m + 1, m + 1)
    Q.diagonal(dim1=-2, dim2=-1).fill_(1)
    return Q


def _inner_cycle(cfg: GmresConfig, basis, beta: torch.Tensor, steps, trigger_tol,
                 minvb_norm: torch.Tensor):
    """The Arnoldi / Givens / policy loop of one cycle and its solution
    coefficients, no host read: ``steps`` steps (m, or under REPEAT after
    the first cycle the first cycle's length).  The Givens and policy tail
    is shared by every basis, in the basis's scalar dtype (the JAX
    package's ``_givens_policy_step``).  ``trigger_tol`` is the residual
    proxy's threshold, None when the cycle has no such trigger.  A policy
    trigger is kept on the device and cuts the cycle afterwards
    (``gmres_tpu/solver/gmres.py:282-298``).

    A batched solve (``solver/batched.py``) runs the lanes of its bases
    here: beta, ``trigger_tol`` (-inf for a lane without the trigger) and
    ``minvb_norm`` are (l,), ``steps`` is each lane's length, the loop runs
    the longest, and every tensor gains the leading lane dimension, each
    lane with the single cycle's elementwise arithmetic.  A lane past its
    own length gets a zero column, which stops its kdim.

    Returns (y, tail): the solution coefficients, zeros past kdim, and the
    cycle's (k_final, |s(k+1)|) in fp64."""
    m = cfg.m
    dt = basis.dtype
    dev = beta.device
    lanes = tuple(beta.shape)
    longest = max(steps) if lanes else steps
    H = torch.zeros((*lanes, m + 1, m), dtype=dt, device=dev)
    # accumulated rotation product Q = G_{k-1}...G_0; the Givens right-hand
    # side is s = beta * Q[:, 0] (ops/givens.py:accumulate_rotation)
    Q = _identity_rotations(lanes, m, dt, dev)
    kdim = torch.zeros(lanes, dtype=torch.int64, device=dev)
    bd = torch.zeros(lanes, dtype=torch.bool, device=dev)
    arn = torch.zeros((*lanes, m), dtype=_f64, device=dev)
    # the first k+1 at which the policy fired, m while it has not
    trig_k = torch.full(lanes, m, dtype=torch.int64, device=dev)
    orthloss = cfg.policy == RestartPolicy.LOST_ORTHOGONALITY
    S = torch.zeros((*lanes, m + 1, m + 1), dtype=dt, device=dev) if orthloss else None
    loss_sq = torch.zeros(lanes, dtype=_f64, device=dev)
    for k in range(longest):
        with span("step", k=k):
            # column k of H under the k previous rotations; then generate and
            # fold in the new one
            hhat, h_next = basis.step(k, Q)
            with span("step.givens"):
                r_, c_, s_ = rotg(hhat[..., k], hhat[..., k + 1])
                hhat[..., k] = r_
                hhat[..., k + 1] = 0
                Q = accumulate_rotation(Q, k, c_, s_)
                # happy breakdown: kdim counts the columns the solution update may
                # use; it stops advancing once h(k+1,k) or r_kk is zero
                kdim = torch.where(bd | (r_ == 0), kdim, k + 1)
                bd = bd | (h_next == 0) | (r_ == 0)
                H[..., k] = hhat
                arnoldi = torch.abs(beta * Q[..., k + 1, 0]).to(_f64)
                arn[..., k] = arnoldi
                # the restart policy (IterUtil.hpp check()), on the device
                trigger = None if trigger_tol is None else arnoldi / minvb_norm <= trigger_tol
                if orthloss:
                    with span("step.orth"):
                        loss_sq = basis.orthloss(S, k, loss_sq)
                    lost = loss_sq >= cfg.restart_improvement ** 2
                    trigger = lost if trigger is None else trigger | lost
                if trigger is not None:
                    trig_k = torch.where(trigger, torch.clamp(trig_k, max=k + 1), trig_k)
    with span("cycle.update"):
        # the post-hoc trigger: the cycle ended at trig_k
        k_fin = (torch.minimum(trig_k, torch.tensor(steps, device=dev)) if lanes
                 else torch.clamp(trig_k, max=steps))
        kdim = torch.minimum(kdim, trig_k)
        # solution_update (gmres.cpp:276-303): y = H[:k,:k]^{-1} s[:k] with
        # s = beta Q e1 (kdim <= k_fin bounds it)
        s_fin = beta.unsqueeze(-1) * Q[..., 0]
        y = trsv_upper_padded(H[..., :longest, :longest], s_fin[..., :longest], kdim)
        # |s(k+1)| at the (possibly post-hoc) cycle end: the recorded proxy,
        # since rotations after the trigger have touched that row of Q
        tail = torch.stack([k_fin.to(_f64),
                            arn.gather(-1, (k_fin - 1).unsqueeze(-1)).squeeze(-1)], dim=-1)
    return y, tail


def restart_cycle(cfg: GmresConfig, A_out, A_in, M, b, x, b_norm, minvb_norm,
                  a_norm, pstate: PolicyState, pending: torch.Tensor | None = None,
                  comm=None):
    """One outer iteration: the residual and the check_initial quantities,
    read to the host together with ``pending`` (the previous cycle's
    k_final and |s(k+1)|) in the cycle's one host read; then unless
    converged the inner loop and the in-place solution update.  Returns
    (x, CycleInfo).

    With ``comm`` (a distributed solve, ``parallel/dist_gmres.py``) the
    operators, M, b and x are the rank's blocks and every reduction is
    summed over the ranks, so the scalars read here are the same on every
    rank, in every precision tier."""
    in_dt = cfg.precision.inner_dtype
    with span("cycle.residual"):
        r, r_ss, x_ss = outer_residual(A_out, b, x, in_dt, comm)
        if cfg.precision.df64_inner:
            # the fp64 residual split into a pair is the df64 start vector
            w0h, w0l = df64.typesafe_apply_df64(M, *df64.split_f64(r), comm)
            beta = df64.df_norm(w0h, w0l, comm)
        else:
            w0 = typesafe_apply(M, r.to(in_dt), comm)
            beta = nrm2(w0, comm)
        r_norm = torch.sqrt(r_ss)
        rel_initial = r_norm / (b_norm + a_norm * torch.sqrt(x_ss))
        prec_rel0 = beta.to(_f64) / minvb_norm
        scalars = torch.stack([rel_initial, prec_rel0, beta.to(_f64), r_norm])
        if pending is not None:
            scalars = torch.cat([scalars, pending])
    with span("cycle.read"):
        rel, prec, beta_h, rn, *rest = scalars.tolist()
    prev = None
    if rest:
        prev = (int(rest[0]), rest[1])
        pstate = with_first_length(pstate, prev[0])
    finite = all(v == v and abs(v) != float("inf") for v in (rel, beta_h))
    converged0 = rel <= cfg.tol
    if converged0 or not finite:
        return x, CycleInfo(converged0, not finite, rn, beta_h, rel, prec, pstate,
                            prev_tail=prev)

    restart_tol = cycle_threshold(cfg, pstate, prec)
    basis = (_PairBasis(cfg, A_in, M, w0h, w0l, beta, comm) if cfg.precision.df64_inner
             else _NativeBasis(cfg, A_in, M, w0, beta, comm))
    y, tail = _inner_cycle(cfg, basis, beta, cycle_steps(cfg, pstate),
                           restart_tol if residual_policy(cfg, pstate) else None, minvb_norm)
    # x += V[:k]^T y promoted to the outer dtype
    with span("cycle.update"):
        x = basis.update(x, y)
    return x, CycleInfo(False, False, rn, beta_h, rel, prec, next_state(pstate, restart_tol),
                        tail=tail, prev_tail=prev)


def drive_restarts(cycle, x, cfg: GmresConfig, record_history=False,
                   progress=None, checkpoint=None,
                   stall_window: int | None = None, ckpt_consensus=None) -> GmresResult:
    """The host outer loop: the reference's ``check_initial`` bookkeeping
    (restart counting, abort, convergence; ``IterUtil.hpp:42-51``,
    including the count-before-test quirk).  ``cycle(x, pstate, pending)``
    runs one restart cycle and returns (x, CycleInfo).

    A cycle's length and final |s(k+1)| stay on the device until the next
    cycle's read, so the host reads once per cycle (plus once after the
    last cycle when the solve aborts at ``max_restarts``); a cycle's
    bookkeeping (iteration count, history, ``progress``) is done when they
    arrive.

    ``checkpoint`` (a ``utils.checkpoint.CheckpointSpec``): a solve resumes
    from the file when it exists, and after every ``every``-th restart the
    pending cycle's length is read first, so that the saved restart count,
    iteration count, x and policy state describe the same cycle.

    ``stall_window``: a cycle whose relative residual is not below 0.9 of
    the best so far, ``stall_window`` or more restarts after the best, ends
    the solve with ``stalled`` set (``gmres_tpu/solver/gmres.py:1300-1322``),
    that cycle's update included.  With a checkpoint the stall is saved
    (``checkpoint.save_stalled``), and a solve with a ``stall_window`` that
    resumes a file so marked runs no cycle and returns it as stalled.

    The distributed solve (``parallel/dist_gmres.py:_dist_ckpt_hooks``)
    saves each rank's block of x to a file of its own and passes
    ``ckpt_consensus(state)``, which turns this rank's loaded state (or
    None) into the one every rank resumes from."""
    pstate = initial_policy_state()
    history = [] if record_history else None
    total_iters = 0
    i = 0
    resumed_stall = False
    if checkpoint is not None:
        state = ckpt.load_phase(checkpoint.path)
        if ckpt_consensus is not None:
            state = ckpt_consensus(state)
        if state is not None:
            x_np, i, total_iters, pstate, resumed_stall = state
            x = torch.tensor(x_np, dtype=x.dtype, device=x.device)
            resumed_stall = resumed_stall and stall_window is not None
    converged = aborted = diverged = False
    stalled = resumed_stall
    rel_prec_res = float("nan")
    best_rel, best_i = float("inf"), 0
    last = None  # (i, CycleInfo) of the cycle whose tail is still on the device

    def settle(tail):
        nonlocal total_iters
        i_prev, info_prev = last
        k, arn = tail
        total_iters += k
        if record_history:
            history.append(dict(i=i_prev, k=k, rel_initial=info_prev.rel_initial,
                                prec_rel0=info_prev.prec_rel0, arnoldi_final=arn))
        if progress is not None:
            progress(i_prev, k, info_prev.rel_initial)

    while not stalled:
        if i + 1 > cfg.max_restarts:
            aborted = True
            break
        with span("cycle", i=i):
            x, info = cycle(x, pstate, None if last is None else last[1].tail)
        if last is not None:
            settle(info.prev_tail)
            last = None
        pstate = info.pstate
        if info.diverged:
            diverged = aborted = True
            break
        if info.converged0:
            converged = True
            rel_prec_res = info.prec_rel0
            if record_history:
                history.append(dict(i=i, k=0, rel_initial=info.rel_initial,
                                    prec_rel0=info.prec_rel0))
            break
        last = (i, info)
        i += 1
        if info.rel_initial < 0.9 * best_rel:
            best_rel, best_i = info.rel_initial, i - 1
        elif stall_window is not None and i - 1 - best_i >= stall_window:
            stalled = True
            break
        if checkpoint is not None and i % checkpoint.every == 0:
            with span("cycle.read"):
                k, arn = last[1].tail.tolist()
            settle((int(k), arn))
            pstate = with_first_length(pstate, int(k))
            last = None
            ckpt.save(checkpoint.path, x, i, total_iters, pstate)
    if last is not None:
        with span("cycle.read"):
            k, arn = last[1].tail.tolist()
        settle((int(k), arn))
    if stalled and checkpoint is not None and not resumed_stall:
        ckpt.save_stalled(checkpoint, x, i, total_iters, pstate)
    return GmresResult(x=x, converged=converged, aborted=aborted,
                       total_iters=total_iters, restarts=i, final_k=0,
                       rel_prec_res=rel_prec_res, history=history,
                       diverged=diverged, stalled=stalled)


def resolve_device(device) -> torch.device:
    """The device a solve runs on.  CUDA is never swapped for the CPU: on a
    machine without a CUDA device, asking for one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _vector(v, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(v), dtype=dtype, device=dev)


def _require_supported(cfg: GmresConfig) -> None:
    """Raise for configuration values that need parts not ported yet."""
    if cfg.axis_name is not None:
        raise NotImplementedError(
            "axis_name names the JAX package's mesh axis; a distributed solve is "
            "gmres_tpu_torch.solve_distributed, called on every rank")


def _format(A, cfg: GmresConfig):
    """With ``cfg.auto_format`` a CSR matrix is repacked on the host: to DIA
    when it is banded enough, else to SELL unless the padding is too large
    (``gmres_tpu/solver/gmres.py:862-915``); anything else is kept.  A bf16
    inner operator that DIA refuses stays CSR: the JAX package packs SELL
    for an fp32 inner operator only (``:889-898``), and K5 has no bf16 form."""
    if not (cfg.auto_format and isinstance(A, CSRMatrix)):
        return A
    packed = from_csr(A)
    if packed is None and cfg.precision.inner_dtype != torch.bfloat16:
        packed = sell_from_csr(A)
    return A if packed is None else packed


def prepare_operators(A, cfg: GmresConfig, device):
    """Stage the matrix into (outer, inner) dtypes on ``device``, repacked
    by ``_format``.  When the dtypes match one operator serves both roles
    (``gmres.cpp:136-141``).

    The df64 tier stages alike on both devices: on DIA the inner operator
    is a ``DF64Dia`` (the fp64 bands as fp32 pairs, K8) and the outer one
    stays the fp64 ``DIAMatrix``; a SELL or CSR operator serves both roles
    in fp64, its pair SpMV a merge, the fp64 SpMV and a split.  (The JAX
    package splits only on the TPU and keeps fp64 on its CPU branch.)"""
    A_fmt = _format(A, cfg).to(device)
    A_in = A_fmt.astype(cfg.precision.inner_dtype)
    same = cfg.precision.outer_dtype == cfg.precision.inner_dtype
    A_out = A_in if same else A_fmt.astype(cfg.precision.outer_dtype)
    if cfg.precision.df64_inner and isinstance(A_in, DIAMatrix):
        A_in = DF64Dia.from_dia(A_in)
    return A_out, A_in


def stage(A, cfg: GmresConfig | None = None, device="cuda"):
    """Pre-stage an operator for repeated solves: the repack (CSR -> DIA or
    SELL) and the upload happen once here instead of inside every
    ``solve`` (the reference's pre-timed deep_copy,
    ``gmres_perf_test.cpp:218-221``).  Returns the staged operator, so a
    caller sees which format it got."""
    cfg = cfg or GmresConfig()
    dev = resolve_device(device)
    with span("stage"):
        with span("stage.pack"):
            packed = _format(A, cfg)
        with span("stage.upload"):
            return packed.to(dev)


def _permuted(v, perm: np.ndarray):
    """v[perm] for a numpy array or a tensor (on the tensor's device)."""
    if isinstance(v, torch.Tensor):
        return v[torch.as_tensor(perm, device=v.device)]
    return np.asarray(v)[perm]


def solve(A, b, cfg: GmresConfig | None = None, x0=None, M=None,
          record_history: bool = False, progress=None, device="cuda",
          reorder: str | None = None, checkpoint=None) -> GmresResult:
    """Solve A x = b with restarted GMRES(m) under the configured precision
    staging, orthogonalization, preconditioner and restart policy, on
    ``device`` (CUDA by default; the CPU only when asked for).

    ``A`` is the assembled (typically fp64) CSR matrix or a staged operator
    from ``stage``; ``b`` and ``x0`` are numpy arrays or tensors.  ``M`` is
    a preconditioner from ``build_preconditioner``, built from the CSR
    matrix when none is given.  The returned ``x`` lies on ``device``.

    ``reorder="rcm"`` (or ``cfg.auto_reorder`` on a CSR matrix that DIA
    refuses, with neither ``M`` nor ``x0`` given) permutes A symmetrically
    by reverse Cuthill-McKee on the host, solves the permuted system and
    returns the un-permuted solution (``gmres_tpu/solver/gmres.py:1038-1062``).

    ``checkpoint`` is a ``utils.checkpoint.CheckpointSpec`` (see
    ``drive_restarts``).  A bf16 inner loop that stalls (``bf16_escalation``,
    tol < 1e-5) is continued from its iterate by a solve with an fp32 inner
    dtype and the restarts left (at least 1), with M rebuilt from ``A`` unless
    one was given, its counts from zero and its checkpoint in a file of its
    own (``CheckpointSpec.continuation``); ``escalated`` is set, the
    restarts, iterations and times are summed and the histories joined by
    ``{"escalated": True}``.  Then,
    with ``cfg.nan_fallback``, a diverged solve in any other precision than
    ``baseline`` is solved again in ``baseline`` from ``A`` with M rebuilt
    from it (``fellback_to_fp64`` is set and the first solve's times are
    added); a staged operator with an ILU preconditioner raises
    ``TypeError`` there, as any solve that needs to build M from it."""
    with span("solve", entry="solve", lanes=1):
        cfg = cfg or GmresConfig()
        dev = resolve_device(device)
        _require_supported(cfg)
        if (reorder is None and cfg.auto_reorder and isinstance(A, CSRMatrix)
                and M is None and x0 is None and from_csr(A) is None):
            reorder = "rcm"
        perm = None
        if reorder is not None:
            if reorder != "rcm":
                raise ValueError(f"unknown reorder {reorder!r}")
            if M is not None:
                raise ValueError("reorder with a prebuilt preconditioner is unsupported")
            if not isinstance(A, CSRMatrix):
                raise TypeError(f"reorder needs the assembled CSR matrix, got {type(A).__name__}")
            perm = rcm_permutation(A)
            A = permute_symmetric(A, perm)
            b = _permuted(b, perm)
            if x0 is not None:
                x0 = _permuted(x0, perm)
        out_dt = cfg.precision.outer_dtype
        in_dt = cfg.precision.inner_dtype
        b_in, M_in = b, M

        with span("solve.prepare"):
            t0 = time.perf_counter()
            if M is None:
                M = build_preconditioner(A, cfg)
            if cfg.auto_format:
                # ILU-Jacobi factors: DIA when banded, else sliced ELL
                M = sell_pack_factors(optimize_precond_format(M))
            A_out, A_in = prepare_operators(A, cfg, dev)
            M = M.to(dev)
            prec_seconds = time.perf_counter() - t0

            b = _vector(b, out_dt, dev)
            # a copy: x is updated in place
            x = torch.zeros_like(b) if x0 is None else _vector(x0, out_dt, dev).clone()

            t1 = time.perf_counter()
            # one-time norms (gmres.cpp:51-57, 162-168); ||A||_F from the inner-dtype
            # values, as gmres.cpp:168 takes it from A_single
            b_norm = nrm2(b).to(_f64)
            minvb_norm = nrm2(typesafe_apply(M, b.to(in_dt))).to(_f64)
            a_norm = nrm2(A_in.vals).to(_f64)
            setup_seconds = time.perf_counter() - t0

        def cycle(x, pstate, pending):
            return restart_cycle(cfg, A_out, A_in, M, b, x, b_norm, minvb_norm,
                                 a_norm, pstate, pending)

        # a bf16 inner loop floors around a relative residual of ~1e-6: watch
        # for a stall so that the solve can continue in fp32
        stall_window = (6 if in_dt == torch.bfloat16 and cfg.bf16_escalation and cfg.tol < 1e-5
                        else None)
        result = drive_restarts(cycle, x, cfg, record_history, progress, checkpoint, stall_window)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result.prec_seconds = prec_seconds
        result.setup_seconds = setup_seconds
        result.solve_seconds = time.perf_counter() - t1
        if result.stalled and not result.converged and in_dt == torch.bfloat16:
            p = cfg.precision
            esc = solve(A, b_in, cfg.with_(
                precision=PrecisionSpec(outer=p.outer, inner="float32", precond=p.precond),
                max_restarts=max(1, cfg.max_restarts - result.restarts)),
                x0=result.x, M=M_in, record_history=record_history, progress=progress,
                device=dev, checkpoint=None if checkpoint is None else checkpoint.continuation())
            esc.escalated = True
            esc.total_iters += result.total_iters
            esc.restarts += result.restarts
            esc.prec_seconds += prec_seconds
            esc.solve_seconds += result.solve_seconds
            if record_history:
                esc.history = result.history + [dict(escalated=True)] + esc.history
            result = esc
        baseline = PrecisionSpec.from_mode("baseline")
        if result.diverged and cfg.nan_fallback and cfg.precision != baseline:
            fb = solve(A, b_in, cfg.with_(precision=baseline), record_history=record_history,
                       progress=progress, device=dev)
            fb.fellback_to_fp64 = True
            fb.prec_seconds += prec_seconds
            fb.solve_seconds += result.solve_seconds
            result = fb
        if perm is not None:
            x = torch.empty_like(result.x)
            x[torch.as_tensor(perm, device=dev)] = result.x
            result.x = x
        return result
