"""Hand-written Hopper kernels of the port and their wrappers.

Each wrapper keeps a plain-int launch count (``wrapper.launches``), so a
run can show that the main path went through its kernels.
"""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """Name -> wrapper for every kernel launch site of the main path."""
    from gmres_tpu_torch.ops.cuda.orth_kernel import gram_cuda, update_gram_cuda, update_sumsq_cuda
    from gmres_tpu_torch.ops.cuda.outer_kernel import basis_axpy_cuda
    from gmres_tpu_torch.ops.cuda.sell_kernel import sell_residual_cuda, sell_spmv_cuda
    from gmres_tpu_torch.ops.cuda.spmv_kernel import dia_residual_cuda, dia_spmv_cuda

    return {
        "dia_spmv": dia_spmv_cuda,
        "dia_residual": dia_residual_cuda,
        "sell_spmv": sell_spmv_cuda,
        "sell_residual": sell_residual_cuda,
        "basis_gram": gram_cuda,
        "basis_update_gram": update_gram_cuda,
        "basis_update_sumsq": update_sumsq_cuda,
        "basis_axpy": basis_axpy_cuda,
    }


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
