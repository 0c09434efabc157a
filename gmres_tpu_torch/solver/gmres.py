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

How it runs on the card.  Under the FIXED policy the inner loop is a
Python ``for k in range(m)`` that never reads a value back to the host: no
``.item()`` and no ``if`` on a tensor; the happy-breakdown guard is a
``torch.where`` and the triangular solve is bounded by the device-side
``kdim``.  So the loop only enqueues work, and the host reads the cycle's
scalars once, at the start of the next cycle.  The hot operations run on
hand-written kernels: the SpMV (K1 on DIA operators, K5 on sliced-ELL
ones), the CGSR basis sweeps (K2, K3), the outer residual (K1 or K5 in
residual mode) and the solution update (K4).  x is updated in place.

Operators are staged as in the JAX package: DIA when the pattern is banded
enough, else SELL, else CSR.  The JAX package packs SELL only on the TPU
and from n = 128K rows; those gates were the TPU's, and the port packs SELL
at every size on both devices.

Not ported, because they exist for the TPU only: the padding of n to the
Pallas block size, the double-float outer staging, the staging cache, the
bf16 escalation and the NaN fallback.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gmres_tpu_torch.config import GmresConfig
from gmres_tpu_torch.ops.blas import nrm2
from gmres_tpu_torch.ops.cuda.outer_kernel import basis_axpy, outer_residual
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.ops.givens import accumulate_rotation, rotg
from gmres_tpu_torch.ops.orth import orthonormalize_step
from gmres_tpu_torch.ops.reorder import permute_symmetric, rcm_permutation
from gmres_tpu_torch.ops.sell import sell_from_csr
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.ops.tri import trsv_upper_padded
from gmres_tpu_torch.precond.apply import typesafe_apply
from gmres_tpu_torch.precond.build import build_preconditioner
from gmres_tpu_torch.solver.policies import (
    PolicyState,
    initial_policy_state,
    require_supported,
)
from gmres_tpu_torch.sparse import CSRMatrix

_f64 = torch.float64


@dataclasses.dataclass
class CycleInfo:
    """Per-restart scalars, read to the host once per cycle."""

    converged0: bool             # check_initial convergence test
    diverged: bool               # non-finite residual or start-vector norm
    r_norm: float                # unpreconditioned residual norm
    beta: float                  # preconditioned residual norm
    rel_initial: float           # r_norm / (||b|| + ||A||_F ||x||)
    prec_rel0: float             # beta / ||M^{-1} b||
    k_final: int                 # inner iterations this cycle
    arnoldi_final: torch.Tensor | float  # |s(k+1)| at cycle end (on device)
    pstate: PolicyState


@dataclasses.dataclass
class GmresResult:
    x: torch.Tensor
    converged: bool
    aborted: bool
    total_iters: int
    restarts: int                 # the reference's `i` at termination
    final_k: int                  # 0 when converged at check_initial
    rel_prec_res: float           # beta/||M^{-1}b|| at the converged check
    prec_seconds: float = 0.0
    solve_seconds: float = 0.0
    setup_seconds: float = 0.0
    history: list | None = None   # per-cycle (i, k, rel_initial, prec_rel0, ...)
    diverged: bool = False


def _inner_cycle(cfg: GmresConfig, A_in, M, w0: torch.Tensor, beta: torch.Tensor):
    """The Arnoldi / Givens loop of one FIXED-policy cycle: m steps, no
    host read.  Returns (V, H, Q, kdim, arn)."""
    m = cfg.m
    in_dt = cfg.precision.inner_dtype
    dev = w0.device
    V = torch.zeros((m + 1, w0.shape[0]), dtype=in_dt, device=dev)
    V[0] = torch.where(beta != 0, w0 / beta, torch.zeros_like(w0))
    H = torch.zeros((m + 1, m), dtype=in_dt, device=dev)
    # accumulated rotation product Q = G_{k-1}...G_0; the Givens right-hand
    # side is s = beta * Q[:, 0] (ops/givens.py:accumulate_rotation)
    Q = torch.eye(m + 1, dtype=in_dt, device=dev)
    kdim = torch.zeros((), dtype=torch.int64, device=dev)
    bd = torch.zeros((), dtype=torch.bool, device=dev)
    arn = torch.zeros(m, dtype=_f64, device=dev)
    for k in range(m):
        w = typesafe_apply(M, spmv(A_in, V[k]))
        h_col, w, h_next = orthonormalize_step(cfg.orth.value, V, k, w, cfg.orth_steps)
        # the reference divides unconditionally (Orthogonalization.hpp:59);
        # a zero h(k+1,k) gives a zero vector instead of NaNs
        V[k + 1] = torch.where(h_next != 0, w / h_next, torch.zeros_like(w))
        h_col[k + 1] = h_next
        # apply all k previous rotations at once (rows > k of Q are still
        # identity), then generate and fold in the new one (gmres.cpp:106-110)
        hhat = torch.mv(Q, h_col)
        r_, c_, s_ = rotg(hhat[k], hhat[k + 1])
        hhat[k] = r_
        hhat[k + 1] = 0
        Q = accumulate_rotation(Q, k, c_, s_)
        # happy breakdown: kdim counts the columns the solution update may
        # use; it stops advancing once h(k+1,k) or r_kk is zero
        kdim = torch.where(bd | (r_ == 0), kdim, k + 1)
        bd = bd | (h_next == 0) | (r_ == 0)
        H[:, k] = hhat
        arn[k] = torch.abs(beta * Q[k + 1, 0]).to(_f64)
    return V, H, Q, kdim, arn


def restart_cycle(cfg: GmresConfig, A_out, A_in, M, b, x, b_norm, minvb_norm,
                  a_norm, pstate: PolicyState):
    """One outer iteration: the residual and the check_initial quantities
    (the cycle's one host read), then unless converged the inner loop and
    the in-place solution update.  Returns (x, CycleInfo)."""
    in_dt = cfg.precision.inner_dtype
    m = cfg.m
    r, r_ss, x_ss = outer_residual(A_out, b, x, in_dt)
    w0 = typesafe_apply(M, r.to(in_dt))
    beta = nrm2(w0)
    r_norm = torch.sqrt(r_ss)
    rel_initial = r_norm / (b_norm + a_norm * torch.sqrt(x_ss))
    prec_rel0 = beta.to(_f64) / minvb_norm
    rel, prec, beta_h, rn = torch.stack(
        [rel_initial, prec_rel0, beta.to(_f64), r_norm]).tolist()
    finite = all(v == v and abs(v) != float("inf") for v in (rel, beta_h))
    converged0 = rel <= cfg.tol
    if converged0 or not finite:
        return x, CycleInfo(converged0, not finite, rn, beta_h, rel, prec, 0, 0.0, pstate)

    V, H, Q, kdim, arn = _inner_cycle(cfg, A_in, M, w0, beta)
    # solution_update (gmres.cpp:276-303): y = H[:k,:k]^{-1} s[:k] with
    # s = beta Q e1; x += V[:k]^T y promoted to the outer dtype
    s_fin = beta * Q[:, 0]
    y = trsv_upper_padded(H[:m, :m], s_fin[:m], kdim)
    x = basis_axpy(x, V, y)
    # FIXED: no policy threshold; the first cycle's length is recorded
    new_pstate = pstate._replace(
        is_first=False,
        second_restart_length=m if pstate.is_first else pstate.second_restart_length)
    return x, CycleInfo(False, False, rn, beta_h, rel, prec, m, arn[m - 1], new_pstate)


def drive_restarts(cycle, x, cfg: GmresConfig, record_history=False,
                   progress=None) -> GmresResult:
    """The host outer loop: the reference's ``check_initial`` bookkeeping
    (restart counting, abort, convergence; ``IterUtil.hpp:42-51``,
    including the count-before-test quirk).  ``cycle(x, pstate)`` runs one
    restart cycle and returns (x, CycleInfo)."""
    pstate = initial_policy_state()
    history = [] if record_history else None
    arnoldi = []  # device scalars, read back in one transfer at the end
    total_iters = 0
    converged = aborted = diverged = False
    rel_prec_res = float("nan")
    i = 0
    while True:
        if i + 1 > cfg.max_restarts:
            aborted = True
            break
        x, info = cycle(x, pstate)
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
        total_iters += info.k_final
        if record_history:
            arnoldi.append(info.arnoldi_final)
            history.append(dict(i=i, k=info.k_final, rel_initial=info.rel_initial,
                                prec_rel0=info.prec_rel0))
        if progress is not None:
            progress(i, info.k_final, info.rel_initial)
        i += 1
    if arnoldi:
        for h, a in zip(history, torch.stack(arnoldi).tolist()):
            h["arnoldi_final"] = a
    return GmresResult(x=x, converged=converged, aborted=aborted,
                       total_iters=total_iters, restarts=i, final_k=0,
                       rel_prec_res=rel_prec_res, history=history,
                       diverged=diverged)


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
    p = cfg.precision
    if p.df64_inner or p.basis is not None or "bfloat16" in (p.outer, p.inner, p.precond):
        raise NotImplementedError(
            "the df64, compressed-basis and bf16 precision tiers are slice 5 of the port")
    if cfg.nan_fallback:
        raise NotImplementedError("nan_fallback is slice 5 of the port")
    if cfg.orth.value == "mgs":
        raise NotImplementedError("orth='mgs' is slice 4 of the port")
    require_supported(cfg.policy)
    if cfg.axis_name is not None:
        raise NotImplementedError("distributed solves (axis_name) are slice 7 of the port")


def _format(A, cfg: GmresConfig):
    """With ``cfg.auto_format`` a CSR matrix is repacked on the host: to DIA
    when it is banded enough, else to SELL unless the padding is too large
    (``gmres_tpu/solver/gmres.py:862-915``); anything else is kept."""
    if not (cfg.auto_format and isinstance(A, CSRMatrix)):
        return A
    packed = from_csr(A)
    if packed is None:
        packed = sell_from_csr(A)
    return A if packed is None else packed


def prepare_operators(A, cfg: GmresConfig, device):
    """Stage the matrix into (outer, inner) dtypes on ``device``, repacked
    by ``_format``.  When the dtypes match one operator serves both roles
    (``gmres.cpp:136-141``)."""
    A_fmt = _format(A, cfg).to(device)
    A_in = A_fmt.astype(cfg.precision.inner_dtype)
    same = cfg.precision.outer_dtype == cfg.precision.inner_dtype
    A_out = A_in if same else A_fmt.astype(cfg.precision.outer_dtype)
    return A_out, A_in


def stage(A, cfg: GmresConfig | None = None, device="cuda"):
    """Pre-stage an operator for repeated solves: the repack (CSR -> DIA or
    SELL) and the upload happen once here instead of inside every
    ``solve`` (the reference's pre-timed deep_copy,
    ``gmres_perf_test.cpp:218-221``).  Returns the staged operator, so a
    caller sees which format it got."""
    cfg = cfg or GmresConfig()
    dev = resolve_device(device)
    return _format(A, cfg).to(dev)


def _permuted(v, perm: np.ndarray):
    """v[perm] for a numpy array or a tensor (on the tensor's device)."""
    if isinstance(v, torch.Tensor):
        return v[torch.as_tensor(perm, device=v.device)]
    return np.asarray(v)[perm]


def solve(A, b, cfg: GmresConfig | None = None, x0=None, M=None,
          record_history: bool = False, progress=None, device="cuda",
          reorder: str | None = None) -> GmresResult:
    """Solve A x = b with restarted GMRES(m) under the configured precision
    staging, orthogonalization, preconditioner and restart policy, on
    ``device`` (CUDA by default; the CPU only when asked for).

    ``A`` is the assembled (typically fp64) CSR matrix or a staged operator
    from ``stage``; ``b`` and ``x0`` are numpy arrays or tensors.  The
    returned ``x`` lies on ``device``.

    ``reorder="rcm"`` (or ``cfg.auto_reorder`` on a CSR matrix that DIA
    refuses, with neither ``M`` nor ``x0`` given) permutes A symmetrically
    by reverse Cuthill-McKee on the host, solves the permuted system and
    returns the un-permuted solution (``gmres_tpu/solver/gmres.py:1038-1062``)."""
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

    t0 = time.perf_counter()
    if M is None:
        M = build_preconditioner(A, cfg)
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

    def cycle(x, pstate):
        return restart_cycle(cfg, A_out, A_in, M, b, x, b_norm, minvb_norm,
                             a_norm, pstate)

    result = drive_restarts(cycle, x, cfg, record_history, progress)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    result.prec_seconds = prec_seconds
    result.setup_seconds = setup_seconds
    result.solve_seconds = time.perf_counter() - t1
    if perm is not None:
        x = torch.empty_like(result.x)
        x[torch.as_tensor(perm, device=dev)] = result.x
        result.x = x
    return result
