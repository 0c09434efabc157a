"""Build, load and launch the port's CUDA kernels.

The sources under ``gmres_tpu_torch/csrc`` have a plain C interface.  At
first use each is compiled for Hopper (``sm_90a``) by its own ``nvcc``, all
started together, and the objects are linked into
``build/gmres_tpu_torch/<hash>/libgmres_kernels.so`` at the root of the
checkout, keyed by a hash of the sources and flags, and loaded with
``ctypes``.  A build takes seconds, against minutes for a source that
includes PyTorch's headers.  Nothing here runs at import: the CPU tests
import every module on a machine without ``nvcc``.

A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "gmres_tpu_torch"
SOURCES = ("dia_spmv.cu", "basis_sweep.cu", "sell_spmv.cu")
HEADERS = ("common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types.  Every pointer and the stream are
# c_void_p: an undeclared Python int would be passed as a 32-bit int.
_SIGNATURES = {
    "gmres_dia_spmv_f32": (_P, _P, _P, _I, _I, _I, _P, _P),
    "gmres_dia_spmv_f64": (_P, _P, _P, _I, _I, _I, _P, _P),
    "gmres_dia_residual_f32": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P),
    "gmres_dia_residual_f64": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P),
    "gmres_sell_spmv_f32": (_P, _P, _P, _P, _P, _I, _P),
    "gmres_sell_spmv_f64": (_P, _P, _P, _P, _P, _I, _P),
    "gmres_sell_residual_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "gmres_sell_residual_f64": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "gmres_basis_gram_f32": (_P, _P, _P, _I, _I, _I, _P),
    "gmres_basis_gram_f64": (_P, _P, _P, _I, _I, _I, _P),
    "gmres_basis_update_gram_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gmres_basis_update_gram_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gmres_basis_update_sumsq_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gmres_basis_update_sumsq_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gmres_basis_axpy_f32_f64": (_P, _P, _P, _I, _I, _P),
    "gmres_basis_axpy_f64_f64": (_P, _P, _P, _I, _I, _P),
    "gmres_basis_axpy_f32_f32": (_P, _P, _P, _I, _I, _P),
}
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class KernelLibrary:
    """The loaded shared library and the launch geometry it was compiled
    with: threads per block, basis tile width, largest basis height and
    largest band count."""

    def __init__(self, path: Path, build_log: str, build_seconds: float):
        self.path = path
        self.build_log = build_log
        self.build_seconds = build_seconds
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.gmres_error_string.argtypes = (ctypes.c_int,)
        self._lib.gmres_error_string.restype = ctypes.c_char_p
        vals = [ctypes.c_int() for _ in range(4)]
        self._lib.gmres_kernel_shape(*(ctypes.byref(v) for v in vals))
        self.threads, self.tile, self.max_rows, self.max_diags = (v.value for v in vals)

    def call(self, name: str, *args) -> None:
        """Launch through C entry point ``name`` on the current stream
        (appended as the last argument); raise if CUDA refused the launch."""
        code = getattr(self._lib, name)(*args, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            msg = self._lib.gmres_error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


_LIB: KernelLibrary | None = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of gmres_tpu_torch are built at first use on a "
        "machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> str:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile and link in a private directory and rename the library into
    # place, so that a concurrent builder never loads a half-written one
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{src}.o") for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in cmds]
        results = []
        for cmd, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate()
            results.append((cmd, proc.returncode, stdout, stderr))
        lib = os.path.join(tmp, out.name)
        link = [nvcc, *ARCH, "-shared", "-o", lib, *objs]
        if all(code == 0 for _, code, _, _ in results):
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((link, proc.returncode, proc.stdout, proc.stderr))
        log = "".join(f"{' '.join(cmd)}\n{so}{se}" for cmd, _, so, se in results)
        failed = [(cmd, code) for cmd, code, _, _ in results if code != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0][1]}): {' '.join(failed[0][0])}\n{log}")
        (out.parent / "build.log").write_text(log)
        os.replace(lib, out)
    return log


def library() -> KernelLibrary:
    """The kernel library, built on the first call after a source change."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            out = BUILD_ROOT / source_hash() / "libgmres_kernels.so"
            if out.is_file():
                log_file = out.parent / "build.log"
                log = log_file.read_text() if log_file.is_file() else ""
            else:
                log = _build(out)
            _LIB = KernelLibrary(out, log, time.perf_counter() - t0)
        return _LIB


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    shape on ``device`` (what a kernel argument must be)."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def kernel_dtype(name: str, t: torch.Tensor) -> str:
    """The entry-point suffix for ``t``'s dtype; raise for other dtypes."""
    if t.dtype not in SUFFIX:
        raise TypeError(f"{name}: the CUDA kernels take float32 or float64, got {t.dtype}")
    return SUFFIX[t.dtype]
