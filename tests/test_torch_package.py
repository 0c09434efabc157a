"""Package-level contracts of the port: it never imports JAX or
``gmres_tpu``; its host-side builders reproduce the JAX package's arrays bit
for bit; its configuration tables match; it never moves to the CPU by
itself; and importing it never runs ``nvcc``."""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.io.rng import rand_vect as jax_rand_vect
from gmres_tpu.ops.dia import from_csr as jax_from_csr
from gmres_tpu.precond.build import build_jacobi as jax_build_jacobi
from gmres_tpu.precond.build import build_jacobi_from_dia as jax_build_jacobi_from_dia
from gmres_tpu_torch.config import Mode
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.io import synth
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.precond.build import build_jacobi, build_jacobi_from_dia

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "gmres_tpu_torch"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_never_imports_jax_or_gmres_tpu():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "gmres_tpu"), (path, name)


@pytest.mark.parametrize("n,seed", [(1, 0), (624, 42), (5000, 42), (1 << 16, 7)])
def test_rand_vect_bit_identical(n, seed):
    a, b = gmres_tpu_torch.rand_vect(n, seed), jax_rand_vect(n, seed)
    assert a.dtype == b.dtype == np.float64
    assert np.array_equal(a.view(np.uint64), b.view(np.uint64))


def _csr_equal(port, ref):
    nnz = ref.nnz
    assert (port.n_rows, port.n_cols, port.nnz) == (ref.n_rows, ref.n_cols, nnz)
    assert np.array_equal(port.row_ptr.numpy(), np.asarray(ref.row_ptr))
    assert np.array_equal(port.col_idx.numpy(), np.asarray(ref.col_idx)[:nnz])
    assert np.array_equal(port.row_ids.numpy(), np.asarray(ref.row_ids)[:nnz])
    assert np.array_equal(port.vals.numpy().view(np.uint64),
                          np.asarray(ref.vals)[:nnz].view(np.uint64))


@pytest.mark.parametrize("builder,args", [
    ("convection_diffusion_2d", (16,)),
    ("convection_diffusion_2d", (33, 20, 2.0)),
    ("poisson_2d", (16,)),
    ("poisson_2d", (9, 14)),
    ("unstructured_mesh", (4096, None, 16, 8)),
    ("unstructured_mesh", (1000, 30, 4, 3, 5)),
    ("random_sparse", (300, 6)),
    ("random_sparse", (1000, 8, 3, 2.0)),
])
def test_synth_builders_bit_identical(builder, args):
    _csr_equal(getattr(synth, builder)(*args), getattr(jax_synth, builder)(*args))


def test_csr_from_dense_bit_identical():
    from gmres_tpu.sparse import csr_from_dense as jax_csr_from_dense
    from gmres_tpu_torch.sparse import csr_from_dense

    a = np.random.default_rng(2).standard_normal((23, 17))
    a[np.abs(a) < 0.8] = 0.0
    _csr_equal(csr_from_dense(a), jax_csr_from_dense(a))


@pytest.mark.parametrize("builder,args", [
    ("convection_diffusion_2d", (12,)), ("unstructured_mesh", (500,)), ("random_sparse", (40, 3))])
def test_to_scipy_matches_jax(builder, args):
    ref = getattr(jax_synth, builder)(*args).to_scipy()
    got = getattr(synth, builder)(*args).to_scipy()
    assert got.shape == ref.shape
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize("case", ["convdiff", "poisson", "refused"])
def test_from_csr_bit_identical(case):
    if case == "convdiff":
        ref = jax_synth.convection_diffusion_2d(40, beta=2.0)
    elif case == "poisson":
        ref = jax_synth.poisson_2d(12, 30)
    else:  # random pattern: too many diagonals, both refuse
        ref = jax_synth.random_sparse(300, row_nnz=6)
    port = csr_from_numpy(np.asarray(ref.row_ptr), np.asarray(ref.col_idx),
                          np.asarray(ref.vals), n_cols=ref.n_cols)
    want, got = jax_from_csr(ref), from_csr(port)
    if want is None:
        assert got is None
        return
    assert got.offsets == want.offsets
    assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols, want.nnz)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_bit_identical(dtype):
    ref = jax_synth.convection_diffusion_2d(20, beta=3.0)
    port = csr_from_numpy(np.asarray(ref.row_ptr), np.asarray(ref.col_idx),
                          np.asarray(ref.vals), n_cols=ref.n_cols)
    tdt = getattr(torch, dtype)
    want = np.asarray(jax_build_jacobi(ref, np.dtype(dtype)).inv_diag)
    assert np.array_equal(build_jacobi(port, tdt).inv_diag.numpy(), want)
    want_dia = np.asarray(jax_build_jacobi_from_dia(jax_from_csr(ref), np.dtype(dtype)).inv_diag)
    assert np.array_equal(build_jacobi_from_dia(from_csr(port), tdt).inv_diag.numpy(), want_dia)


@pytest.mark.parametrize("mode", [m.value for m in Mode])
def test_from_mode_table_matches(mode):
    port = gmres_tpu_torch.PrecisionSpec.from_mode(mode)
    ref = gmres_tpu.PrecisionSpec.from_mode(mode)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.inner_dtype == getattr(torch, str(ref.inner_dtype))
    assert port.precond_dtype == getattr(torch, str(ref.precond_dtype))


def test_config_fields_and_defaults_match():
    def defaults(cls, drop=()):
        out = {}
        for f in dataclasses.fields(cls):
            if f.name in drop:
                continue
            v = f.default
            if dataclasses.is_dataclass(v):
                v = dataclasses.asdict(v)
            out[f.name] = v.value if hasattr(v, "value") else v
        return out

    ref = defaults(gmres_tpu.GmresConfig, drop=("use_pallas",))
    assert defaults(gmres_tpu_torch.GmresConfig) == ref
    assert defaults(gmres_tpu_torch.PrecisionSpec) == defaults(gmres_tpu.PrecisionSpec)


def test_solve_on_cuda_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the contract is about machines without one")
    A = synth.convection_diffusion_2d(8)
    cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond="identity")
    with pytest.raises(RuntimeError, match="CUDA"):
        gmres_tpu_torch.solve(A, np.ones(A.n_rows), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gmres_tpu_torch.stage(A)


@pytest.mark.parametrize("cfg", [
    dict(orth="mgs", precond="identity"),
    dict(orth="cgsr", precond="ilu"),
    dict(orth="cgsr", precond="ilu_jacobi"),
    dict(orth="cgsr", precond="identity", policy="relres"),
    dict(orth="cgsr", precond="identity",
         precision=gmres_tpu_torch.PrecisionSpec.from_mode("df64")),
    dict(orth="cgsr", precond="identity",
         precision=gmres_tpu_torch.PrecisionSpec("float64", "bfloat16", "bfloat16")),
])
def test_unported_options_raise(cfg):
    A = synth.convection_diffusion_2d(8)
    with pytest.raises(NotImplementedError, match="slice"):
        gmres_tpu_torch.solve(A, np.ones(A.n_rows), gmres_tpu_torch.GmresConfig(**cfg),
                              device="cpu")


def test_importing_never_runs_nvcc(tmp_path):
    """In a fresh process with a fake nvcc (first on PATH and under
    CUDA_HOME) that records each call: import every module and solve on the
    CPU, and nvcc is not called; then, as a control, ask for the kernel
    library, which calls it once per source (all started together, so each
    fails) and raises."""
    marker = tmp_path / "nvcc_called"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho called >> {marker}\nexit 1\n")
    nvcc.chmod(0o755)
    script = textwrap.dedent(f"""
        import importlib, os, pkgutil
        import numpy as np
        import gmres_tpu_torch
        for mod in pkgutil.walk_packages(gmres_tpu_torch.__path__, "gmres_tpu_torch."):
            importlib.import_module(mod.name)
        from gmres_tpu_torch.io.synth import convection_diffusion_2d
        A = convection_diffusion_2d(8)
        cfg = gmres_tpu_torch.GmresConfig(orth="cgsr", precond="identity", tol=1e-10)
        assert gmres_tpu_torch.solve(A, np.ones(A.n_rows), cfg, device="cpu").converged
        from gmres_tpu_torch.ops.cuda import _build
        assert _build._LIB is None and not os.path.exists({str(marker)!r})
        try:
            _build.library()
        except RuntimeError as e:
            assert "nvcc failed" in str(e)
        else:
            raise AssertionError("the fake nvcc built a library")
        assert open({str(marker)!r}).read().count("called") == len(_build.SOURCES)
        print("ok")
    """)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}",
               CUDA_HOME=str(tmp_path), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
