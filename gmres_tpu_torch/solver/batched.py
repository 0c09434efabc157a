"""Batched multi-RHS GMRES: solve A x_j = b_j for s right-hand sides at
once on one device (``gmres_tpu/solver/batched.py``).

Each lane runs the restart cycle of ``solver/gmres.py`` and gets the
restarts, iterations and history of ``solve(A, B[j], cfg)``.  What is shared
is the host's work and the operator's bytes:

- one host read a cycle for all lanes (the residual scalars and the previous
  cycle's lengths), and one loop of Arnoldi steps, ``solver/gmres.py``'s
  ``_inner_cycle``, whose small Givens and policy launches run over a
  leading lane dimension (``ops/givens.py``, ``ops/tri.py``), all but one
  product a lane;
- the SpMV reads the operator once for all lanes: K1's lane form on a DIA
  operator (``ops/spmv.py:spmv_lanes``), for the Arnoldi steps, the
  ILU-Jacobi sweeps and the outer residual (``outer_residual_lanes``).

Each lane owns its Krylov basis, V of shape (s, m+1, n): lane j is a
single cycle's ``_NativeBasis`` on the contiguous view ``V[j]``, whose row
is orthogonalized by the single-lane step, so the sweeps are
K2, K3 and K7 (or K2x2) with a lane's bits equal to a single solve's; the
rotations' product with the new column is the single cycle's ``torch.mv``
on the lane's Q, and the solution update is K4, lane by lane.  The SpMV's
lanes are bit-equal to K1's, and everything else is elementwise over the
lanes.  So a lane computes what ``solve`` computes for its b, bit for bit
where the kernels' lanes are (on the CPU, their plain versions), and its
result does not depend on the batch's size or on its place in it.

A lane that converges or diverges leaves the active set with its x, and
later cycles run only the live lanes (the JAX package runs every lane under
a mask to the end of its chunk).  Under REPEAT each lane runs its own first
cycle's length: the loop runs the longest, and a lane past its own length
sweeps nothing and adds a zero column that its solution update does not
read.

Left out, as in the JAX package: the df64 inner tier and distributed
solves (both refused), the bf16 stall escalation, the NaN fp64 fallback and
checkpoints.  The default exact-ILU preconditioner is built in its sweep
form (``build_ilu_exact(..., allow_fused=False)``): the same exact solve,
applied to all lanes by K1's lane form.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gmres_tpu_torch.config import GmresConfig, Precond
from gmres_tpu_torch.ops.blas import nrm2
from gmres_tpu_torch.ops.cuda.outer_kernel import outer_residual_lanes
from gmres_tpu_torch.ops.spmv import spmv_lanes
from gmres_tpu_torch.precond.apply import typesafe_apply_lanes
from gmres_tpu_torch.precond.build import (
    build_ilu_exact,
    build_preconditioner,
    optimize_precond_format,
    sell_pack_factors,
)
from gmres_tpu_torch.solver.gmres import (
    GmresResult,
    _inner_cycle,
    _NativeBasis,
    _vector,
    prepare_operators,
    resolve_device,
)
from gmres_tpu_torch.solver.policies import (
    cycle_steps,
    cycle_threshold,
    initial_policy_state,
    next_state,
    residual_policy,
    with_first_length,
)
from gmres_tpu_torch.utils.profiling import span

_f64 = torch.float64


class _LaneBasis:
    """The l live lanes' bases of a cycle, V of shape (l, m+1, n): lane j is
    a single cycle's ``_NativeBasis`` on the view V[j], stepped ``steps[j]``
    times, behind one lane-batched SpMV and preconditioner apply a step."""

    def __init__(self, cfg: GmresConfig, A_in, M, W0: torch.Tensor, beta: torch.Tensor,
                 steps: list):
        n_lanes, n = W0.shape
        self.A_in, self.M, self.steps = A_in, M, steps
        self.dtype = cfg.precision.inner_dtype
        self.V = torch.zeros((n_lanes, cfg.m + 1, n), dtype=cfg.precision.basis_dtype,
                             device=W0.device)
        self.lanes = [_NativeBasis(cfg, A_in, M, W0[j], beta[j], V=self.V[j])
                      for j in range(n_lanes)]
        self.zero_col = torch.zeros(cfg.m + 1, dtype=self.dtype, device=W0.device)

    def step(self, k: int, Q: torch.Tensor):
        """Every lane's step k, its column under its own rotations Q[j]; a
        lane past its own length gets a zero column."""
        with span("step.spmv"):
            AV = spmv_lanes(self.A_in, self.V[:, k])
        with span("step.precond"):
            W = typesafe_apply_lanes(self.M, AV)
        cols = [lane.orthonormalize(k, W[j], Q[j]) if k < self.steps[j]
                else (self.zero_col, self.zero_col[0]) for j, lane in enumerate(self.lanes)]
        with span("step.givens"):
            return torch.stack([c for c, _ in cols]), torch.stack([h for _, h in cols])

    def orthloss(self, S: torch.Tensor, k: int, loss_sq: torch.Tensor) -> torch.Tensor:
        for j, lane in enumerate(self.lanes):
            if k < self.steps[j]:
                loss_sq[j] = lane.orthloss(S[j], k, loss_sq[j])
        return loss_sq

    def update(self, X: torch.Tensor, y: torch.Tensor) -> None:
        """X[j] += V[j]^T y[j] in place, on lane j's own length (K4)."""
        for j, lane in enumerate(self.lanes):
            lane.update(X[j], y[j, :self.steps[j]])


def _right_hand_sides(B, n: int, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """B as an (s, n) tensor on ``dev``: an array or tensor of that shape, or
    a sequence of 1-D ones."""
    B = (_vector(B, dtype, dev) if isinstance(B, (torch.Tensor, np.ndarray))
         else torch.stack([_vector(b, dtype, dev) for b in B]))
    if B.dim() != 2 or B.shape[1] != n:
        raise ValueError(f"B must be (batch, n={n}); got {tuple(B.shape)}")
    return B


def solve_batched(A, B, cfg: GmresConfig | None = None, M=None, record_history: bool = False,
                  device="cuda") -> list[GmresResult]:
    """Solve ``A x_j = b_j`` for every row of ``B`` (shape ``(s, n)``, or a
    sequence of 1-D arrays) on ``device`` (CUDA by default; the CPU only when
    asked for).  Returns one ``GmresResult`` per right-hand side, each with
    the restarts, iterations and (with ``record_history``) history rows of
    ``solve(A, B[j], cfg)``.

    ``A`` is the CSR matrix or a staged operator; ``M`` a preconditioner,
    built from the CSR matrix when none is given (exact ILU in its sweep
    form).  Refused as in the JAX package: the df64 inner tier and
    ``cfg.axis_name``.  A bf16 inner loop runs without ``solve``'s stall
    escalation."""
    cfg = cfg or GmresConfig()
    if cfg.axis_name is not None:
        raise ValueError("solve_batched is single-device; use "
                         "solve_distributed for sharded solves")
    if cfg.precision.df64_inner:
        raise ValueError("solve_batched does not support the df64 inner "
                         "tier (its kernels are unbatched); use solve()")
    dev = resolve_device(device)
    with span("solve", entry="solve_batched", lanes=len(B)):
        with span("solve.prepare"):
            out_dt, in_dt = cfg.precision.outer_dtype, cfg.precision.inner_dtype
            B = _right_hand_sides(B, A.n_rows, out_dt, dev)
            s = B.shape[0]

            t0 = time.perf_counter()
            if M is None:
                M = (build_ilu_exact(A, cfg.precision.precond_dtype, allow_fused=False)
                     if cfg.precond == Precond.ILU else build_preconditioner(A, cfg))
            if cfg.auto_format:
                M = sell_pack_factors(optimize_precond_format(M))
            A_out, A_in = prepare_operators(A, cfg, dev)
            M = M.to(dev)
            prec_seconds = time.perf_counter() - t0

            t1 = time.perf_counter()
            b_norms = torch.stack([nrm2(b).to(_f64) for b in B])
            minvb_norms = torch.stack([nrm2(w).to(_f64)
                                       for w in typesafe_apply_lanes(M, B.to(in_dt))])
            a_norm = nrm2(A_in.vals).to(_f64)
            setup_seconds = time.perf_counter() - t0

        X_out = torch.zeros_like(B)
        live = list(range(s))          # the lanes still iterating, in order
        B_live, X_live, b_live, mv_live = B, X_out.clone(), b_norms, minvb_norms
        ps = [initial_policy_state() for _ in range(s)]
        restarts = [0] * s
        total_iters = [0] * s
        converged = [False] * s
        diverged = [False] * s
        rel_prec = [float("nan")] * s
        history = [[] for _ in range(s)] if record_history else None
        pending = None                 # (l, 2) tails of the live lanes' last cycle
        last = None                    # per live lane, (i, rel_initial, prec_rel0) of its cycle
        i = 0

        def settle(rows):
            for lane, (i_prev, rel0, prec0), (k, arn) in zip(live, last, rows):
                total_iters[lane] += int(k)
                if record_history:
                    history[lane].append(dict(i=i_prev, k=int(k), rel_initial=rel0,
                                              prec_rel0=prec0, arnoldi_final=arn))

        while live:
            if i + 1 > cfg.max_restarts:
                break
            with span("cycle", i=i):
                with span("cycle.residual"):
                    R, r_ss, x_ss = outer_residual_lanes(A_out, B_live, X_live, in_dt)
                    W0 = typesafe_apply_lanes(M, R.to(in_dt))
                    beta = torch.stack([nrm2(w) for w in W0])
                    r_norm = torch.sqrt(r_ss)
                    rel = r_norm / (b_live + a_norm * torch.sqrt(x_ss))
                    prec = beta.to(_f64) / mv_live
                    read = torch.stack([rel, prec, beta.to(_f64)], dim=1)
                    if pending is not None:
                        read = torch.cat([read, pending], dim=1)
                with span("cycle.read"):
                    rows = read.tolist()   # the cycle's one host read, for every lane
                if pending is not None:
                    settle([row[3:] for row in rows])
                    ps = [with_first_length(p, int(row[3])) for p, row in zip(ps, rows)]
                    pending = last = None
                keep = []
                for idx, (lane, (rel0, prec0, beta0, *_)) in enumerate(zip(live, rows)):
                    restarts[lane] = i
                    if not all(v == v and abs(v) != float("inf") for v in (rel0, beta0)):
                        diverged[lane] = True
                    elif rel0 <= cfg.tol:
                        converged[lane] = True
                        rel_prec[lane] = prec0
                        if record_history:
                            history[lane].append(dict(i=i, k=0, rel_initial=rel0,
                                                      prec_rel0=prec0))
                    else:
                        keep.append(idx)
                        continue
                    X_out[lane] = X_live[idx]
                if not keep:
                    live = []
                    break
                if len(keep) < len(live):
                    idx = torch.tensor(keep, device=dev)
                    live = [live[j] for j in keep]
                    B_live, X_live, W0, beta = B_live[idx], X_live[idx], W0[idx], beta[idx]
                    b_live, mv_live = b_live[idx], mv_live[idx]
                    rows = [rows[j] for j in keep]
                    ps = [ps[j] for j in keep]
                restart_tol = [cycle_threshold(cfg, p, row[1]) for p, row in zip(ps, rows)]
                steps = [cycle_steps(cfg, p) for p in ps]
                # the residual trigger's threshold, -inf (never reached) in a lane
                # whose policy has none this cycle
                on = [residual_policy(cfg, p) for p in ps]
                trigger_tol = (torch.tensor([t if o else -float("inf")
                                             for t, o in zip(restart_tol, on)],
                                            dtype=_f64, device=dev) if any(on) else None)
                basis = _LaneBasis(cfg, A_in, M, W0, beta, steps)
                y, pending = _inner_cycle(cfg, basis, beta, steps, trigger_tol, mv_live)
                with span("cycle.update"):
                    basis.update(X_live, y)
                last = [(i, row[0], row[1]) for row in rows]
                ps = [next_state(p, t) for p, t in zip(ps, restart_tol)]
                i += 1
        if pending is not None:
            # the lanes aborted at max_restarts: their last cycle's lengths
            with span("cycle.read"):
                tails = pending.tolist()
            settle(tails)
        for j, lane in enumerate(live):
            restarts[lane] = i
            X_out[lane] = X_live[j]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        solve_seconds = time.perf_counter() - t1
        return [GmresResult(x=X_out[lane], converged=converged[lane],
                            aborted=diverged[lane] or not converged[lane],
                            total_iters=total_iters[lane], restarts=restarts[lane], final_k=0,
                            rel_prec_res=rel_prec[lane], prec_seconds=prec_seconds,
                            solve_seconds=solve_seconds, setup_seconds=setup_seconds,
                            history=history[lane] if record_history else None,
                            diverged=diverged[lane])
                for lane in range(s)]
