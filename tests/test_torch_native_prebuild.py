"""Build the JAX package's native host library once, before any test needs
it, so that concurrent test processes never load a half-written file.

``gmres_tpu/native.py:42-49`` compiles ``csrc/libgmres_native.so`` in place
at first use.  Under pytest-xdist several workers reach that build at once;
one can load the file while another compiler is still writing it, get
``OSError`` and skip every native test of that worker (the 23 cases of
``tests/test_sell_native.py``).  This module builds the library at import,
under an exclusive ``fcntl.flock``, with exactly ``native.py``'s command,
into a temporary file in ``csrc/`` that is renamed into place: a reader sees
no library or the whole one.  Every worker imports this module while
collecting, and xdist starts no test before all workers have collected;
``tests/test_torch_native_prebuild_first/conftest.py`` imports it at start-up
as well, before any test module (and the skip marks that call the build
while they are collected) is imported.

Without ``g++``, or with ``csrc/`` not writable, it builds nothing and
``native.py`` behaves as before.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SRC = CSRC / "gmres_native.cpp"
LIB = CSRC / "libgmres_native.so"


def _command(target: Path) -> list:
    # gmres_tpu/native.py:43-44
    return ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-o", str(target), str(SRC)]


def _up_to_date() -> bool:
    return LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime


def prebuild() -> str:
    """Build ``LIB`` if it is missing or older than its source; return what
    happened ("present", "built", or why nothing was built)."""
    if not SRC.exists():
        return "no source"
    if shutil.which("g++") is None:
        return "no g++"
    if not os.access(CSRC, os.W_OK):
        return "csrc/ not writable"
    key = hashlib.sha256(str(CSRC).encode()).hexdigest()[:16]
    lock_path = Path(tempfile.gettempdir()) / f"gmres_native_build_{key}.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _up_to_date():
            return "present"
        fd, tmp = tempfile.mkstemp(dir=CSRC, prefix=".libgmres_native.", suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run(_command(Path(tmp)), capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                return f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}"
            os.replace(tmp, LIB)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return "built"


PREBUILD = prebuild()


def test_native_library_loads():
    if PREBUILD in ("no g++", "csrc/ not writable", "no source"):
        pytest.skip(f"native library not built here: {PREBUILD}")
    assert PREBUILD in ("present", "built"), PREBUILD
    assert _up_to_date()
    lib = ctypes.CDLL(str(LIB))
    assert hasattr(lib, "ilu0_factorize")
