"""Condition-number estimator (the reference's ``condest.cpp``;
``gmres_tpu/solver/condest.py``).

sigma_max: power iteration on A for the Klein-LU iteration bound
(``condest.cpp:30-33,167-179``).  sigma_min: Golub-Kahan / LSQR
bidiagonalization on a manufactured problem, tracking ``min ||A d|| / ||d||``
over the error vectors ``d = x_exact - x_t`` (``condest.cpp:37-165``).

Operators, all fp64 (``condest_operators``): a banded A runs on DIA (K1's
fp64 plain mode on the card) with A^T as a second DIA matrix
(``ops/dia.py:dia_transpose``); otherwise the sliced ELL of A and of
``transpose_csr(A)`` (K5's fp64 plain mode); CSR only when both refuse.  The
JAX package's double-float SELL route and its per-execution time budget
existed for the TPU only and are not carried.  The BLAS-1 is plain torch.

The protocol is the JAX package's, step for step: the power iteration runs
``max(power_iters, 2 * min(32, power_iters))`` steps (the JAX package runs
its probe twice before the loop); the switch from c1 to c1' is sticky; the
LSQR loop stops on ``finished``, on degeneracy or past ``max_iters`` (t =
max_iters + 1 means it was capped), then runs a tail to ``ceil(1.25 *
(t_fire - 1))`` steps in all, with no tail after degeneracy or the cap.

How it runs on the card.  The stop flags live on the device, and the host
reads them once per ``chunk`` steps.  Every step is masked: once a flag
stops the loop, the remaining steps of the chunk change nothing (the state,
t and sigma_min are kept with ``torch.where``), so t and sigma_min are the
ones of a loop that tested every step.  The tail's length is known on the
host; only degeneracy can end it early, and the same mask does.
The reference's ``v_min`` (the minimizing d) is never reported and is not
kept.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gmres_tpu_torch.io.rng import rand_vect
from gmres_tpu_torch.ops.blas import nrm2
from gmres_tpu_torch.ops.dia import DIAMatrix, dia_transpose, from_csr
from gmres_tpu_torch.ops.sell import sell_from_csr
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.solver.gmres import resolve_device
from gmres_tpu_torch.sparse import CSRMatrix, csr_from_coo

_f64 = torch.float64
CHUNK = 64  # LSQR steps between two reads of the stop flags


def transpose_csr(A: CSRMatrix) -> CSRMatrix:
    """A^T as a CSR matrix, duplicates kept (``gmres_tpu/solver/condest.py:36``)."""
    rp, ci, v = A.numpy_arrays()
    nnz = int(rp[-1])
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp.astype(np.int64)))
    return csr_from_coo(ci[:nnz].astype(np.int64), rows, v[:nnz], n_rows=A.n_cols,
                        n_cols=A.n_rows, sum_duplicates=False)


def klein_lu_bound(eps: float, delta: float, n: int) -> int:
    log_2n = math.log(2 * n)
    return int(math.ceil((log_2n * log_2n - math.log(eps * delta * delta)) / eps))


def condest_operators(A, device):
    """(A, A^T) in fp64 on ``device``: DIA for a banded CSR matrix (or a DIA
    one), else sliced ELL for A and ``transpose_csr(A)``, else CSR."""
    if isinstance(A, DIAMatrix):
        A = A.astype(_f64)
        return A.to(device), dia_transpose(A).to(device)
    if not isinstance(A, CSRMatrix):
        raise TypeError(f"condest takes a CSR or DIA matrix, got {type(A).__name__}")
    A = A.astype(_f64)
    dia = from_csr(A)
    if dia is not None:
        return dia.to(device), dia_transpose(dia).to(device)
    At = transpose_csr(A)
    s, st = sell_from_csr(A), sell_from_csr(At)
    if s is not None and st is not None:
        return s.to(device), st.to(device)
    return A.to(device), At.to(device)


def _lsqr_step(A, At, x_exact, st):
    """One Golub-Kahan step and the sigma_min tracking (condest.cpp:97-133).
    Returns the new state and (||d||, ||A d||, ||x||)."""
    u, v, w, x, alpha, beta, phi_bar, rho_bar, sigma_min = st
    u = spmv(A, v) - alpha * u
    beta = nrm2(u)
    u = torch.where(beta != 0, u / beta, u)
    v = spmv(At, u) - beta * v
    alpha = nrm2(v)
    v = torch.where(alpha != 0, v / alpha, v)

    rho = torch.sqrt(rho_bar ** 2 + beta ** 2)
    c = rho_bar / rho
    s = beta / rho
    theta = s * alpha
    rho_bar = -c * alpha
    phi = c * phi_bar
    phi_bar = s * phi_bar
    x = x + (phi / rho) * w
    w = v + (-theta / rho) * w

    d = x_exact - x
    d_norm = nrm2(d)
    ad_norm = nrm2(spmv(A, d))
    better = (ad_norm < sigma_min * d_norm) & (d_norm != 0)
    sigma_min = torch.where(better, ad_norm / d_norm, sigma_min)
    return (u, v, w, x, alpha, beta, phi_bar, rho_bar, sigma_min), d_norm, ad_norm, nrm2(x)


def condest(A, rand_seed: int = 42, max_iters: int = 100_000, verbose=print, device="cuda",
            chunk: int = CHUNK, stats: dict | None = None):
    """Estimate cond_2(A) of a CSR (or DIA) matrix on ``device`` (CUDA
    unless ``"cpu"`` is given).  Returns (cond, sigma_max, sigma_min, t)
    and prints the reference's lines through ``verbose``.  ``stats``, when
    given, receives the power iteration's and the LSQR loop's seconds and
    the LSQR steps run, masked ones included.  ``chunk`` is the read
    cadence, a seam for the tests that hold every cadence to the same
    bits; callers leave it at ``CHUNK``."""
    dev = resolve_device(device)
    A, At = condest_operators(A, dev)
    n = A.n_rows

    eps = float(np.finfo(np.float64).eps)
    c1 = 8 * eps
    erfinv_c2 = 8.862271574665521045654e-4
    c3 = 1 / (64 * eps)
    c4 = math.sqrt(eps)
    c1_prime = 4 * eps
    power_iters = klein_lu_bound(0.1, 1e-12, n)

    def on_dev(a):
        return torch.as_tensor(a, dtype=_f64, device=dev)

    t0 = time.perf_counter()
    x_p = on_dev(rand_vect(n, rand_seed + 5))
    lam = on_dev(0.0)
    for _ in range(max(power_iters, 2 * min(32, power_iters))):
        y = spmv(A, x_p)
        lam = nrm2(y)
        x_p = torch.where(lam != 0, y / lam, y)
    sigma_max = float(lam)
    power_seconds = time.perf_counter() - t0
    verbose(f"sigma_max = {sigma_max:g}")

    x_exact = on_dev(rand_vect(n, rand_seed))
    x_rand_norm = float(nrm2(x_exact))
    x_exact = x_exact / x_rand_norm
    b = spmv(A, x_exact)
    b_norm = float(nrm2(b))
    beta = b_norm
    u = b / beta
    v = spmv(At, u)
    alpha = float(nrm2(v))
    v = v / alpha
    state = (u, v, v, torch.zeros_like(v), on_dev(alpha), on_dev(beta), on_dev(beta),
             on_dev(alpha), on_dev(sigma_max))
    tau = math.sqrt(2) * erfinv_c2 / x_rand_norm

    # device flags: t, finished, degenerate, relaxed (the sticky c1 -> c1')
    t = torch.ones((), dtype=torch.int64, device=dev)
    fin = torch.zeros((), dtype=torch.bool, device=dev)
    deg = torch.zeros_like(fin)
    relaxed = torch.zeros_like(fin)

    def masked_step(active):
        nonlocal state, t, fin, deg, relaxed
        new, d_norm, ad_norm, x_norm = _lsqr_step(A, At, x_exact, state)
        sigma_min = new[8]
        rel = relaxed | (sigma_min / sigma_max <= c4)
        c1_eff = torch.where(rel, c1_prime, c1)
        f = ((ad_norm / (sigma_max * x_norm + b_norm) <= c1_eff) | (d_norm <= tau)
             | (sigma_max / sigma_min >= c3))
        g = (d_norm == 0) | torch.isnan(ad_norm)
        state = tuple(torch.where(active, a, b) for a, b in zip(new, state))
        t = t + active.to(torch.int64)
        fin = torch.where(active, f, fin)
        deg = torch.where(active, g, deg)
        relaxed = torch.where(active, rel, relaxed)

    def flags():
        return [int(a) for a in torch.stack([t, fin.to(torch.int64),
                                             deg.to(torch.int64)]).tolist()]

    t1 = time.perf_counter()
    steps = 0
    while True:  # until finished, degenerate or capped
        for _ in range(chunk):
            masked_step(~fin & ~deg & (t <= max_iters))
        steps += chunk
        t_now, f_now, g_now = flags()
        if f_now or g_now or t_now > max_iters:
            break
    # the tail to ceil(1.25 * t_fire) steps in all (t_fire = t_now - 1,
    # condest.cpp:142-148); 'finished' is no longer tested, degeneracy is
    t_target = math.ceil((t_now - 1) * 1.25) if (f_now and not g_now) else 0
    while t_now <= t_target and not g_now:
        for _ in range(min(chunk, t_target - t_now + 1)):
            masked_step(~deg & (t <= t_target))
            steps += 1
        t_now, _, g_now = flags()
    sigma_min = float(state[8])
    if stats is not None:
        stats.update(power_seconds=power_seconds, lsqr_seconds=time.perf_counter() - t1,
                     lsqr_steps=steps, power_steps=max(power_iters, 2 * min(32, power_iters)),
                     chunk=chunk)

    verbose(f"{t_now} iterations total")
    cond = sigma_max / sigma_min
    verbose(f"Computed cond(A) = {cond:g} = {sigma_max:g}/{sigma_min:g}")
    return cond, sigma_max, sigma_min, t_now
