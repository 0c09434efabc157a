"""Solver configuration for the PyTorch port.

The same surface as ``gmres_tpu.config``: the reference's four precision
modes, three orthogonalization kernels, four preconditioners and four
restart policies (``gmres_perf_test.cpp:327-394``) as one frozen
dataclass, with the same field names and defaults, so a configuration
reads the same in both packages.  The dtype properties return torch dtypes.

There is no ``use_pallas`` knob: a kernel runs when the tensors lie on a
CUDA device and the plain PyTorch version when they lie on the CPU.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Mode(str, enum.Enum):
    """The reference's four test modes (``gmres_perf_test.cpp:31-36``) and
    the double-float tier."""

    BASELINE = "baseline"          # uniform fp64
    SINGLE_PREC = "single-prec"    # fp64 solver, fp32 preconditioner
    MIXED = "mixed"                # fp64 outer residual, fp32 inner cycle
    SINGLE = "single"              # uniform fp32
    DF64 = "df64"                  # fp64 inner loop as two-fp32 pairs


class Orth(str, enum.Enum):
    """Orthogonalization kernels (``Orthogonalization.hpp:76-136``)."""

    CGS = "cgs"
    MGS = "mgs"
    CGSR = "cgsr"


class Precond(str, enum.Enum):
    """Preconditioners (``gmres_perf_test.cpp:24-29``, ``types.hpp:244-448``)."""

    ILU = "ilu"
    ILU_JACOBI = "ilu_jacobi"
    JACOBI = "jacobi"
    IDENTITY = "identity"
    BILU_JACOBI = "bilu_jacobi"


class RestartPolicy(str, enum.Enum):
    """Restart policies (``IterUtil.hpp:17-227``)."""

    FIXED = "fixed"
    REL_PREC_RES = "relres"
    REPEAT_ITERATION = "repeat"
    LOST_ORTHOGONALITY = "orthloss"


# Canonical dtype names accepted in PrecisionSpec (strings keep the config
# hashable); widest first.
_DTYPES = ("float64", "float32", "bfloat16")
_TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """Explicit dtype staging, generalizing the reference's four modes.

    - ``outer``: dtype of x, b and the true-residual accumulation.
    - ``inner``: dtype of the Krylov basis, Hessenberg matrix, Givens
      rotations and the operator used inside the Arnoldi cycle.
    - ``precond``: dtype the preconditioner is built in and applied in.
    - ``df64_inner``: the fp64 inner loop carried as two-fp32 pairs.
    - ``basis``: storage dtype of the Krylov basis when narrower than
      ``inner`` (compressed basis), None for the inner dtype.
    """

    outer: str = "float64"
    inner: str = "float64"
    precond: str = "float64"
    df64_inner: bool = False
    basis: str | None = None

    def __post_init__(self):
        for name in (self.outer, self.inner, self.precond):
            if name not in _DTYPES:
                raise ValueError(f"unsupported dtype {name!r}; use one of {_DTYPES}")
        if self.df64_inner and self.inner != "float64":
            raise ValueError(
                "df64_inner carries an fp64-quality inner loop as two-fp32 "
                "pairs; set inner='float64' with it"
            )
        if self.basis is not None:
            if self.basis not in _DTYPES:
                raise ValueError(
                    f"unsupported basis dtype {self.basis!r}; use one of {_DTYPES}")
            if self.df64_inner:
                raise ValueError(
                    "basis compression and df64_inner are exclusive")
            if _DTYPES.index(self.basis) < _DTYPES.index(self.inner):
                raise ValueError(
                    f"basis dtype {self.basis!r} is wider than inner "
                    f"{self.inner!r}; compression stores V narrower")

    @staticmethod
    def from_mode(mode: Mode | str) -> "PrecisionSpec":
        mode = Mode(mode)
        if mode == Mode.BASELINE:
            return PrecisionSpec("float64", "float64", "float64")
        if mode == Mode.SINGLE_PREC:
            return PrecisionSpec("float64", "float64", "float32")
        if mode == Mode.MIXED:
            return PrecisionSpec("float64", "float32", "float32")
        if mode == Mode.SINGLE:
            return PrecisionSpec("float32", "float32", "float32")
        if mode == Mode.DF64:
            return PrecisionSpec("float64", "float64", "float32",
                                 df64_inner=True)
        raise ValueError(f"unknown mode {mode}")

    @property
    def outer_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.outer]

    @property
    def inner_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.inner]

    @property
    def precond_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.precond]

    @property
    def basis_dtype(self) -> torch.dtype:
        """Storage dtype of the Krylov basis (the inner dtype unless
        compressed)."""
        return _TORCH_DTYPES[self.basis] if self.basis is not None else self.inner_dtype


@dataclasses.dataclass(frozen=True)
class GmresConfig:
    """Full solver configuration, field for field as ``gmres_tpu``'s.

    Fields the port does not run yet are kept so that a configuration
    means the same thing in both packages; ``solve`` raises
    ``NotImplementedError`` for a value that needs them.  ``host_sync_every``
    has no effect here: the port reads convergence once per restart cycle.
    """

    precision: PrecisionSpec = PrecisionSpec()
    orth: Orth = Orth.MGS
    orth_steps: int = 2  # CGSR re-orthogonalization passes (gmres.cpp:357)
    precond: Precond = Precond.ILU
    jacobi_steps: int = 1
    policy: RestartPolicy = RestartPolicy.FIXED
    restart_length: int = 30
    restart_improvement: float = 0.0  # --rtol / --rorth
    tol: float = 1e-6
    max_restarts: int = 1_000_000
    axis_name: str | None = None
    host_sync_every: int = 16
    auto_format: bool = True
    nan_fallback: bool = False
    bf16_escalation: bool = True
    low_sync_mgs: bool | None = None
    auto_reorder: bool = False

    def __post_init__(self):
        object.__setattr__(self, "orth", Orth(self.orth))
        object.__setattr__(self, "precond", Precond(self.precond))
        object.__setattr__(self, "policy", RestartPolicy(self.policy))
        if self.restart_length < 1:
            raise ValueError("restart_length must be >= 1")
        if self.orth_steps < 1:
            raise ValueError("orth_steps must be >= 1")

    @property
    def m(self) -> int:
        return self.restart_length

    def with_(self, **kw) -> "GmresConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_flags(mode: str = "mixed", orth: str = "mgs", prec: str = "ilu", rlen: int = 30,
                   rtol: float = 0.0, tol: float = 1e-6, max_restarts: int = 1_000_000,
                   repeat_iter: bool = False, orthloss: bool = False, jacobi_steps: int = 1,
                   **kw) -> "GmresConfig":
        """The reference's command-line flags as a configuration
        (``alloc_convergence``, ``gmres_perf_test.cpp:185-196``;
        ``gmres_tpu/config.py:262-304``): rtol == 0 is the fixed restart;
        otherwise ``repeat_iter`` or ``orthloss`` picks the policy, and the
        relative preconditioned residual is the default."""
        if repeat_iter and orthloss:
            raise ValueError("Repeated Iteration Restart cannot be used with OrthLoss restart")
        if rtol == 0:
            policy = RestartPolicy.FIXED
        elif repeat_iter:
            policy = RestartPolicy.REPEAT_ITERATION
        elif orthloss:
            policy = RestartPolicy.LOST_ORTHOGONALITY
        else:
            policy = RestartPolicy.REL_PREC_RES
        return GmresConfig(precision=PrecisionSpec.from_mode(mode), orth=Orth(orth.lower()),
                           precond=Precond(prec), jacobi_steps=jacobi_steps, policy=policy,
                           restart_length=rlen, restart_improvement=rtol, tol=tol,
                           max_restarts=max_restarts, **kw)


def use_lowsync_mgs(cfg: GmresConfig, device_type: str, distributed: bool = False) -> bool:
    """Whether an MGS solve runs the one-reduce ICWY step instead of the
    sequential recurrence.  ``low_sync_mgs=True`` or ``False`` forces the
    form on every device; ``None`` takes ``LOWSYNC_MGS_DEFAULT`` (or, for a
    df64 cycle, ``LOWSYNC_MGS_DF64_DEFAULT``; for a distributed cycle,
    ``LOWSYNC_MGS_DIST_DEFAULT`` by inner dtype) for the device type."""
    if cfg.orth != Orth.MGS:
        return False
    if cfg.low_sync_mgs is not None:
        return bool(cfg.low_sync_mgs)
    if distributed:
        tier = "df64" if cfg.precision.df64_inner else cfg.precision.inner
        return LOWSYNC_MGS_DIST_DEFAULT[device_type][tier]
    table = LOWSYNC_MGS_DF64_DEFAULT if cfg.precision.df64_inner else LOWSYNC_MGS_DEFAULT
    return table[device_type]


# low_sync_mgs=None by device type.  CPU: the JAX package's CPU branch,
# sequential (gmres_tpu/solver/gmres.py:204-208).  CUDA: sequential too, in
# both modes: on the H100 at convdiff@1M one K7 launch a step took 0.0746 /
# 0.1144 ms of host wall a step (fp32 / fp64) against ICWY's 0.1363 /
# 0.1743, and whole solves 0.7707 / 1.0159 s (baseline / mixed medians of 6
# interleaved) against 0.9105 / 1.0881 (chip_smoke.py, PERF.md).  The JAX
# package's TPU rule (ICWY except for fp64 cycles) came from the TPU's
# emulated fp64 and does not carry.
LOWSYNC_MGS_DEFAULT = {"cpu": False, "cuda": False}

# The same for df64 cycles.  CPU: the JAX package's CPU branch, sequential
# (gmres_tpu/solver/gmres.py:325-328).  CUDA: ICWY.  Sequential df64 MGS is
# a one-row K9 and a one-row K11 per basis row, 2(k+1) launches a step; on
# the H100 at convdiff@1M its orthogonalization step took 1.7642 ms of host
# wall against ICWY's 0.3248, and whole solves 2.9628 s against 1.5394
# (medians of 3 interleaved; chip_smoke.py, PERF.md).
LOWSYNC_MGS_DF64_DEFAULT = {"cpu": False, "cuda": True}

# The same for distributed cycles, by inner dtype (and "df64" for the df64
# tier; a compressed basis takes its inner dtype's entry).  CPU: the JAX
# package's rules, ICWY for non-fp64 native cycles and sequential for fp64
# ones (gmres_tpu/solver/gmres.py:204-208), ICWY for every distributed df64
# cycle (:325-328).  CUDA: ICWY in every tier.  Distributed
# sequential MGS sums each of its k+1 dots over the ranks before the next
# row can start (one collective a row, in plain torch), where ICWY sums
# twice a step: with 4 gloo ranks sharing one H100 at convdiff@1M, whole
# solves took 52.83 s sequential against 10.09 s ICWY in mixed and 59.56 s
# against 11.79 s in baseline (medians of 3 and 2 interleaved, 26/780 each;
# chip_smoke.py, PERF.md).
LOWSYNC_MGS_DIST_DEFAULT = {
    "cpu": {"float64": False, "float32": True, "bfloat16": True, "df64": True},
    "cuda": {"float64": True, "float32": True, "bfloat16": True, "df64": True}}
