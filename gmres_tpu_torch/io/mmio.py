"""MatrixMarket reading and writing in numpy (``gmres_tpu/io/mmio.py``).

The reference bundles NIST's ``mmio.c``; this reader is built on
``np.loadtxt``.  The typecode model follows the MM spec: ``matrix
(coordinate|array) (real|integer|pattern|complex)
(general|symmetric|skew-symmetric|hermitian)``.  The JAX package's native
strtol/strtod parser (``gmres_tpu/native.py``) is not carried: it parses the
same digits to the same doubles, so the arrays are the same.
``read_coordinate_rows`` streams a file for the distributed per-host input
(``io/loader.py:load_matrix_rows``), keeping only the entries of a row
block.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


class MMIOError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class MMHeader:
    fmt: str        # "coordinate" | "array"
    field: str      # "real" | "integer" | "pattern" | "complex"
    symmetry: str   # "general" | "symmetric" | "skew-symmetric" | "hermitian"
    n_rows: int
    n_cols: int
    nnz: int | None  # None for array format

    @property
    def is_coordinate(self) -> bool:
        return self.fmt == "coordinate"

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"


def _read_banner(f) -> tuple[str, str, str]:
    banner = f.readline()
    if not banner:
        raise MMIOError("Banner is missing")
    parts = banner.split()
    if len(parts) < 5:
        raise MMIOError("Missing values in banner")
    if parts[0] != "%%MatrixMarket" or parts[1].lower() != "matrix":
        raise MMIOError("Banner is missing")
    fmt, field, symmetry = (p.lower() for p in parts[2:5])
    if fmt not in ("coordinate", "array"):
        raise MMIOError("Unrecognized description")
    if field not in ("real", "integer", "pattern", "complex"):
        raise MMIOError("Unrecognized description")
    if symmetry not in ("general", "symmetric", "skew-symmetric", "hermitian"):
        raise MMIOError("Unrecognized description")
    return fmt, field, symmetry


def _read_size_line(f) -> list[int]:
    while True:
        line = f.readline()
        if not line:
            raise MMIOError("Malformed matrix size information")
        line = line.strip()
        if line and not line.startswith("%"):
            try:
                return [int(tok) for tok in line.split()]
            except ValueError as e:
                raise MMIOError("Malformed matrix size information") from e


def read_header(path: str | os.PathLike) -> MMHeader:
    with open(path, "r") as f:
        fmt, field, symmetry = _read_banner(f)
        size = _read_size_line(f)
        if fmt == "coordinate":
            if len(size) != 3:
                raise MMIOError("Malformed matrix size information")
            return MMHeader(fmt, field, symmetry, size[0], size[1], size[2])
        if len(size) != 2:
            raise MMIOError("Malformed matrix size information")
        return MMHeader(fmt, field, symmetry, size[0], size[1], None)


def read(path: str | os.PathLike):
    """Read a .mtx file.

    Returns ``(header, data)`` where for coordinate format ``data`` is
    ``(rows, cols, vals)`` (0-based int64 indices; vals are float64, or all
    ones for pattern files), and for array format ``data`` is a dense
    ``(n_rows, n_cols)`` float64 array in column-major entry order as
    stored.
    """
    with open(path, "r") as f:
        fmt, field, symmetry = _read_banner(f)
        size = _read_size_line(f)
        if fmt == "coordinate":
            if len(size) != 3:
                raise MMIOError("Malformed matrix size information")
            n_rows, n_cols, nnz = size
            header = MMHeader(fmt, field, symmetry, n_rows, n_cols, nnz)
            ncols_data = 2 if field == "pattern" else (4 if field == "complex" else 3)
            if nnz == 0:
                raw = np.empty((0, ncols_data), dtype=np.float64)
            else:
                raw = np.loadtxt(f, dtype=np.float64, comments="%", ndmin=2, max_rows=nnz)
            if raw.shape[0] != nnz or raw.shape[1] < ncols_data:
                raise MMIOError("Malformed matrix data")
            rows = raw[:, 0].astype(np.int64) - 1
            cols = raw[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(nnz, dtype=np.float64)
            elif field == "complex":
                vals = raw[:, 2] + 1j * raw[:, 3]
            else:
                vals = raw[:, 2]
            return header, (rows, cols, vals)
        else:
            if len(size) != 2:
                raise MMIOError("Malformed matrix size information")
            n_rows, n_cols = size
            header = MMHeader(fmt, field, symmetry, n_rows, n_cols, None)
            flat = np.loadtxt(f, dtype=np.float64, comments="%").reshape(-1)
            if symmetry == "general":
                expected = n_rows * n_cols
            else:
                expected = n_rows * (n_rows + 1) // 2
            if flat.shape[0] != expected:
                raise MMIOError("Malformed matrix data")
            if symmetry == "general":
                dense = flat.reshape(n_cols, n_rows).T  # column-major storage
            else:
                dense = np.zeros((n_rows, n_cols), dtype=np.float64)
                # MM stores the lower triangle column-major: for each col j, rows j..n-1
                idx = 0
                for j in range(n_cols):
                    cnt = n_rows - j
                    dense[j:, j] = flat[idx : idx + cnt]
                    idx += cnt
                dense = dense + np.tril(dense, -1).T
            return header, dense


def _parse_entries(buf: bytes, pattern: bool):
    """0-based (rows, cols, vals) of the coordinate lines in ``buf``."""
    import io

    raw = np.loadtxt(io.StringIO(buf.decode()), dtype=np.float64, comments="%", ndmin=2)
    if raw.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float64)
    r = raw[:, 0].astype(np.int64) - 1
    c = raw[:, 1].astype(np.int64) - 1
    v = np.ones(r.shape[0]) if pattern else raw[:, 2]
    return r, c, v


def read_coordinate_rows(path: str | os.PathLike, row_lo: int, row_hi: int,
                         chunk_bytes: int = 64 << 20):
    """Stream a coordinate .mtx keeping only the entries that assembled
    rows ``[row_lo, row_hi)`` need (``gmres_tpu/io/mmio.py:
    read_coordinate_rows``): an entry (r, c, v) when r is in range or, in a
    symmetric file, when c is (its mirror lands in the block).  The file is
    parsed ``chunk_bytes`` at a time, so the memory held is that of the
    kept entries, a chunk and n counts.

    Returns ``(header, rows, cols, vals, counts)``: the kept entries,
    0-based, in file order, and ``counts[r]``, the assembled entry count of
    every global row (the forced diagonal, the off-diagonals and their
    mirrors), whose cumulative sum is the assembled global row pointer."""
    header = read_header(path)
    if not header.is_coordinate or header.field not in ("real", "integer", "pattern"):
        raise MMIOError("row-block reading supports coordinate real/integer/pattern files")
    symmetric = header.symmetry in ("symmetric", "skew-symmetric")
    pattern = header.field == "pattern"
    counts = np.ones(header.n_rows, dtype=np.int64)  # the forced diagonal of each row
    kept = []
    remaining = header.nnz

    def take(buf: bytes) -> None:
        nonlocal remaining
        r, c, v = _parse_entries(buf, pattern)
        if r.shape[0] == 0:
            return
        remaining -= r.shape[0]
        off = r != c
        np.add.at(counts, r[off], 1)
        keep = (r >= row_lo) & (r < row_hi)
        if symmetric:
            np.add.at(counts, c[off], 1)
            keep |= (c >= row_lo) & (c < row_hi)
        if keep.any():
            kept.append((r[keep], c[keep], v[keep]))

    with open(path, "rb") as f:
        f.readline()  # the banner
        while True:  # comments, then the size line; the entries follow it
            line = f.readline()
            if not line:
                raise MMIOError("Malformed matrix size information")
            line = line.strip()
            if line and not line.startswith(b"%"):
                break
        tail = b""
        while remaining > 0:
            buf = f.read(chunk_bytes)
            if not buf:
                break
            buf = tail + buf
            cut = buf.rfind(b"\n")
            if cut < 0:
                tail = buf
                continue
            tail = buf[cut + 1:]
            take(buf[:cut + 1])
        if remaining > 0 and tail.strip():
            take(tail + b"\n")
    if remaining != 0:
        raise MMIOError(f"Malformed matrix data ({remaining} entries missing)")
    parts = list(zip(*kept)) if kept else ([], [], [])
    cat = lambda ps, dt: np.concatenate(ps) if ps else np.empty(0, dt)
    return (header, cat(parts[0], np.int64), cat(parts[1], np.int64),
            cat(parts[2], np.float64), counts)


def write_coordinate(
    path: str | os.PathLike,
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray | None = None,
    symmetry: str = "general",
    field: str | None = None,
    comment: str | None = None,
):
    """Write a coordinate .mtx file (1-based on disk)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if field is None:
        field = "pattern" if vals is None else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{n_rows} {n_cols} {rows.shape[0]}\n")
        if vals is None:
            np.savetxt(f, np.column_stack([rows + 1, cols + 1]), fmt="%d %d")
        else:
            np.savetxt(
                f,
                np.column_stack([rows + 1, cols + 1, np.asarray(vals)]),
                fmt="%d %d %.17g",
            )


def write_array(path: str | os.PathLike, a: np.ndarray, comment: str | None = None):
    """Write a dense array .mtx file (column-major entry order)."""
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    if a.shape[0] == 1 and a.ndim == 2 and a.shape[1] > 1:
        a = a.T
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{a.shape[0]} {a.shape[1]}\n")
        np.savetxt(f, a.T.reshape(-1), fmt="%.17g")
