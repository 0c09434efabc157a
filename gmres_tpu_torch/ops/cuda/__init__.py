"""Hand-written Hopper kernels of the port and their wrappers.

Each wrapper keeps a plain-int launch count (``wrapper.launches``), so a
run can show that the main path went through its kernels.  K4's pair mode
(``outer_kernel.basis_axpy_pair_cuda``) counts into ``basis_axpy``.  The
wrappers of kernels with dtype forms (K2, K2x2, K3's three modes, K4, K7)
and of K1's and K5's plain modes ("f32", "f64") also count each form's
launches (``wrapper.forms``, by entry-point suffix; K4's pair mode as
"pair").  K1's lane form counts into K1's wrappers, in both modes, as the
form "<dtype>_lanes<L>" of a launch over L lanes."""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """Name -> wrapper for every kernel launch site of the main path."""
    from gmres_tpu_torch.ops.cuda.df64_orth_kernel import (
        df_gram_cuda,
        df_update_gram_cuda,
        df_update_sumsq_cuda,
    )
    from gmres_tpu_torch.ops.cuda.df64_spmv_kernel import dia_spmv_df64_cuda
    from gmres_tpu_torch.ops.cuda.halo_kernel import dia_residual_halo_cuda, dia_spmv_halo_cuda
    from gmres_tpu_torch.ops.cuda.mgs_kernel import mgs_cuda
    from gmres_tpu_torch.ops.cuda.orth_kernel import (
        gram2_cuda,
        gram_cuda,
        update_cuda,
        update_gram_cuda,
        update_sumsq_cuda,
    )
    from gmres_tpu_torch.ops.cuda.outer_kernel import basis_axpy_cuda
    from gmres_tpu_torch.ops.cuda.sell_kernel import sell_residual_cuda, sell_spmv_cuda
    from gmres_tpu_torch.ops.cuda.spmv_kernel import dia_residual_cuda, dia_spmv_cuda
    from gmres_tpu_torch.ops.cuda.trisolve_kernel import (
        ilu_trisolve_fused_cuda,
        ilu_trisolve_segmented_cuda,
    )

    return {
        "dia_spmv": dia_spmv_cuda,
        "dia_residual": dia_residual_cuda,
        "sell_spmv": sell_spmv_cuda,
        "sell_residual": sell_residual_cuda,
        "basis_gram": gram_cuda,
        "basis_update_gram": update_gram_cuda,
        "basis_update_sumsq": update_sumsq_cuda,
        "basis_axpy": basis_axpy_cuda,
        "ilu_trisolve_fused": ilu_trisolve_fused_cuda,
        "ilu_trisolve_segmented": ilu_trisolve_segmented_cuda,
        "basis_mgs": mgs_cuda,
        "basis_gram2": gram2_cuda,
        "basis_update": update_cuda,
        "dia_spmv_df64": dia_spmv_df64_cuda,
        "df_gram": df_gram_cuda,
        "df_update_gram": df_update_gram_cuda,
        "df_update_sumsq": df_update_sumsq_cuda,
        "dia_spmv_halo": dia_spmv_halo_cuda,
        "dia_residual_halo": dia_residual_halo_cuda,
    }


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "forms"):
            fn.forms.clear()


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def form_launch_counts() -> dict:
    """Kernel -> {form: launches} for the kernels with dtype forms."""
    return {name: dict(fn.forms) for name, fn in kernel_wrappers().items()
            if hasattr(fn, "forms")}
