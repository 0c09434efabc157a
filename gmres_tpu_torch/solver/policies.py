"""Restart/convergence policy state.

FIXED (``Convergence``, ``IterUtil.hpp:57-65``) restarts after
``restart_length`` inner iterations.  ``check_initial`` counts the restart
before testing convergence, so ``max_restarts`` bounds outer iterations
including the final converged one (``IterUtil.hpp:42-51``; replicated in the
restart driver).  The state below carries across restarts; under FIXED it is
inert.  The other three policies are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

from gmres_tpu_torch.config import RestartPolicy


class PolicyState(NamedTuple):
    """Cross-restart policy state (host values)."""

    is_first: bool                 # no restart has triggered yet
    second_restart_length: int     # inner length recorded at the first restart
    restart_tol: float             # frozen first-cycle threshold


def initial_policy_state() -> PolicyState:
    return PolicyState(is_first=True, second_restart_length=0, restart_tol=0.0)


def require_supported(policy: RestartPolicy) -> None:
    if policy != RestartPolicy.FIXED:
        raise NotImplementedError(
            f"restart policy {policy.value!r} is slice 4 of the port; only "
            "'fixed' runs")
