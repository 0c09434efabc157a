"""Restart/convergence policies (``IterUtil.hpp:17-227``).

The reference consults a ``Convergence`` object from host code every inner
iteration.  Here, as in ``gmres_tpu/solver/policies.py``, every policy is a
predicate evaluated on the device inside the restart cycle, and only the
small cross-restart state below lives on the host:

- FIXED (``Convergence``): restart when ``restart_length <= k+1``
  (``IterUtil.hpp:57-65``).  ``check_initial`` counts the restart before
  testing convergence, so ``max_restarts`` bounds outer iterations
  including the final converged one (``IterUtil.hpp:42-51``; replicated in
  the restart driver).
- REL_PREC_RES (``RelPrecRes_Convergence``): also restart when the Arnoldi
  residual proxy ``|s(k+1)|/||M^{-1}b||`` drops to ``restart_improvement``
  times this cycle's initial preconditioned relative residual
  (``IterUtil.hpp:150-165``).
- REPEAT_ITERATION (``RepeatIteration_Convergence``): like REL_PREC_RES with
  the threshold frozen from the first cycle; every later cycle restarts at
  the first cycle's length (``IterUtil.hpp:84-137``).  That length is a
  host int once the next cycle has read it, so those cycles simply run that
  many steps.
- LOST_ORTHOGONALITY (``LostOrthogonality_Convergence``): the loss
  recurrence ``s_col = u - S u`` with ``u = V_{0:k+1}^T v_{k+1}``, restarting
  when the accumulated squared loss reaches ``restart_improvement^2``
  (``IterUtil.hpp:172-227``).  S is per-cycle state.

A trigger inside a cycle is kept on the device (``trig_k``, the first k+1
at which the policy fired): the loop enqueues all its steps and the cycle
is cut to ``trig_k`` afterwards, which gives the early exit's results
because a Givens rotation G_j touches only rows j, j+1
(``gmres_tpu/solver/gmres.py:156-165``).

A batched solve (``solver/batched.py``) keeps a ``PolicyState`` for each
of its lanes: each lane's threshold comes from its own ``prec_rel0`` and,
under REPEAT, each lane runs its own first cycle's length.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gmres_tpu_torch.config import GmresConfig, RestartPolicy

_f64 = torch.float64


class PolicyState(NamedTuple):
    """Cross-restart policy state (host values)."""

    is_first: bool                 # no cycle has run its inner loop yet
    second_restart_length: int     # the first cycle's length; 0 until it is read
    restart_tol: float             # this (REPEAT: the first) cycle's threshold


def initial_policy_state() -> PolicyState:
    return PolicyState(is_first=True, second_restart_length=0, restart_tol=0.0)


def residual_policy(cfg: GmresConfig, pstate: PolicyState) -> bool:
    """Whether this cycle restarts on the residual proxy: REL_PREC_RES
    always, REPEAT_ITERATION in its first cycle."""
    return cfg.policy == RestartPolicy.REL_PREC_RES or (
        cfg.policy == RestartPolicy.REPEAT_ITERATION and pstate.is_first)


def cycle_threshold(cfg: GmresConfig, pstate: PolicyState, prec_rel0: float) -> float:
    """The threshold of the residual proxy for this cycle
    (``gmres_tpu/solver/gmres.py:510-518``)."""
    if residual_policy(cfg, pstate):
        return prec_rel0 * cfg.restart_improvement
    return pstate.restart_tol


def cycle_steps(cfg: GmresConfig, pstate: PolicyState) -> int:
    """Arnoldi steps to enqueue: the first cycle's length for REPEAT after
    the first cycle (its trigger ``second_restart_length <= k+1`` as a loop
    bound), else m."""
    if cfg.policy == RestartPolicy.REPEAT_ITERATION and not pstate.is_first:
        return min(pstate.second_restart_length, cfg.m)
    return cfg.m


def orthloss_step(S: torch.Tensor, k: int, u: torch.Tensor, loss_sq: torch.Tensor):
    """One step of the loss recurrence: u = <v_j, v_{k+1}> for j <= k (zero
    past k); column k+1 of S becomes s = u - S u on rows 0..k (S's rows > k
    are zero there), and ||s||^2 is added to loss_sq in fp64.  S is
    updated in place.  Returns loss_sq."""
    r = k + 1
    s_col = u[:r] - torch.mv(S[:r, :r], u[:r])
    S[:r, r] = s_col
    return loss_sq + torch.dot(s_col, s_col).to(_f64)


def next_state(pstate: PolicyState, restart_tol: float) -> PolicyState:
    """The state after a cycle that ran its inner loop
    (``gmres_tpu/solver/gmres.py:556-562``); the first cycle's length is
    filled in by the next cycle's read (``with_first_length``)."""
    return PolicyState(is_first=False, second_restart_length=pstate.second_restart_length,
                       restart_tol=restart_tol)


def with_first_length(pstate: PolicyState, k_prev: int) -> PolicyState:
    """Record the first cycle's length once it has been read: ``k_prev`` is
    the length of the cycle before the current one."""
    if pstate.is_first or pstate.second_restart_length:
        return pstate
    return pstate._replace(second_restart_length=k_prev)
