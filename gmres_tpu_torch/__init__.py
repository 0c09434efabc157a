"""gmres_tpu_torch: the PyTorch and CUDA port of ``gmres_tpu``.

Restarted mixed-precision GMRES(m) for one NVIDIA Hopper GPU, with the hot
operations on hand-written CUDA kernels (``csrc/``) and everything else in
plain torch.  Module for module it follows ``gmres_tpu``, which stays the
reference; this package imports neither JAX nor ``gmres_tpu``.

    from gmres_tpu_torch import GmresConfig, PrecisionSpec, solve, stage
    A_dev = stage(A)                                   # CSR -> DIA, upload
    res = solve(A_dev, b, GmresConfig(precision=PrecisionSpec.from_mode("mixed"),
                                      orth="cgsr", precond="identity"))

``solve`` runs on ``device="cuda"`` unless told ``device="cpu"``.
"""

from gmres_tpu_torch.config import GmresConfig, PrecisionSpec
from gmres_tpu_torch.io.rng import rand_vect
from gmres_tpu_torch.solver.gmres import GmresResult, solve, stage

__all__ = ["GmresConfig", "GmresResult", "PrecisionSpec", "rand_vect", "solve", "stage"]
