#!/usr/bin/env python3
"""The ``orthloss`` restart policy under CGS (identity) and MGS (Jacobi) on
the CPU: restarts and iterations of the JAX package, of the port (plain
versions of its kernels) and of the dense numpy oracle
(``tests/oracle_gmres.py``) on ``unstructured_mesh(1024, run=8)``, restart
length 20, tol 1e-8, restart_improvement 1e-2, baseline and mixed -- the
cases ``tests/test_torch_policies.py:test_orthloss_matches_dense_oracle``
holds the port to the oracle on.  Prints one JSON line per case.

    JAX_PLATFORMS=cpu python scripts/port_orthloss_cpu.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import gmres_tpu
    import gmres_tpu_torch
    from gmres_tpu.io.synth import unstructured_mesh
    from gmres_tpu_torch.convert import csr_from_numpy
    from oracle_gmres import oracle_solve
    from test_torch_solver import _dense, _problem

    A = unstructured_mesh(1024, run=8)
    _, b = _problem(A)
    D = _dense(A)
    A_port = csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                            n_cols=A.n_cols)
    for orth, prec in (("cgs", "identity"), ("mgs", "jacobi")):
        for mode in ("baseline", "mixed"):
            kw = dict(orth=orth, precond=prec, policy="orthloss", restart_improvement=1e-2,
                      restart_length=20, tol=1e-8, max_restarts=400)
            jax_res = gmres_tpu.solve(A, b, gmres_tpu.GmresConfig(
                precision=gmres_tpu.PrecisionSpec.from_mode(mode), **kw))
            port = gmres_tpu_torch.solve(A_port, b, gmres_tpu_torch.GmresConfig(
                precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), **kw), device="cpu")
            ref = oracle_solve(D, b, tol=1e-8, rlen=20, max_restarts=400, orth=orth, mode=mode,
                               policy="orthloss", rtol=1e-2,
                               inv_diag=1.0 / np.diag(D) if prec == "jacobi" else None)
            print(json.dumps({"orth": orth, "precond": prec, "mode": mode,
                              "jax": [jax_res.restarts, jax_res.total_iters],
                              "port": [port.restarts, port.total_iters],
                              "oracle": [ref.restarts, ref.total_iters]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
