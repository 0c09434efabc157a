"""gmres_tpu_torch: the PyTorch and CUDA port of ``gmres_tpu``.

Restarted mixed-precision GMRES(m) for one NVIDIA Hopper GPU, with the hot
operations on hand-written CUDA kernels (``csrc/``) and everything else in
plain torch.  Module for module it follows ``gmres_tpu``, which stays the
reference; this package imports neither JAX nor ``gmres_tpu``.

    from gmres_tpu_torch import GmresConfig, PrecisionSpec, solve, stage
    A_dev = stage(A)                       # CSR -> DIA or SELL, upload
    res = solve(A_dev, b, GmresConfig(precision=PrecisionSpec.from_mode("mixed"),
                                      orth="cgsr", precond="identity"))

``solve`` runs on ``device="cuda"`` unless told ``device="cpu"``.
"""

from gmres_tpu_torch.config import (
    GmresConfig,
    Mode,
    Orth,
    PrecisionSpec,
    Precond,
    RestartPolicy,
)
from gmres_tpu_torch.io.rng import rand_vect
from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.ops.sell import SELLMatrix, sell_from_csr
from gmres_tpu_torch.solver.gmres import GmresResult, solve, stage
from gmres_tpu_torch.sparse import CSRMatrix, csr_from_coo, csr_from_dense

__all__ = [
    "CSRMatrix",
    "DIAMatrix",
    "GmresConfig",
    "GmresResult",
    "Mode",
    "Orth",
    "PrecisionSpec",
    "Precond",
    "RestartPolicy",
    "SELLMatrix",
    "csr_from_coo",
    "csr_from_dense",
    "rand_vect",
    "sell_from_csr",
    "solve",
    "stage",
]
