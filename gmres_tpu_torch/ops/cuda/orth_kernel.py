"""K2/K3 and K2x2 wrappers: the basis sweeps of one CGS, CGSR or ICWY-MGS
step (``csrc/basis_sweep.cu``), each beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/orth_kernel.py``'s ``_gram``, ``_gram2``,
``_update``, ``_update_gram``, ``_update_sumsq`` and the chain
``cgsr2_pallas``:

    gram:          u = V w
    gram2:         u = [V w0, V w1], (m+1, 2), one sweep
    update:        w1 = w - u^T V
    update_gram:   w1 = w - u^T V,  u2 = V w1
    update_sumsq:  w2 = w - u^T V,  ||w2||^2

``V`` is the (m+1, n) row-stored Krylov basis.  Only its first ``rows``
rows are read: inside the Arnoldi loop rows k+1..m are still zero, so the
solver passes ``rows = k + 1`` (the host loop index) and the result is the
same as a sweep over all m+1 rows.  Outputs keep the full (m+1,) length
with zeros past ``rows``.

Dtype forms (``_build.SWEEP_FORMS``): the basis V in fp32 or fp64 against
vectors of its own dtype, and for the compressed-basis and bf16 tiers a
bf16 basis against fp32 or bf16 vectors and an fp32 basis against fp64
ones.  Sums run in the accumulation dtype (``_build.acc_dtype``: fp64 under
fp64 vectors, else fp32) and the outputs are rounded to the vectors'
dtype, as the TPU kernels do: u2 of ``update_gram`` and ||w'||^2 of
``update_sumsq`` are taken from w' before it is rounded, and the sum of
squares stays in the accumulation dtype.  K2x2 is K2's kernel with two
vectors; the ICWY step passes it vectors in the accumulation dtype, and
each column of its (m+1, 2) output has the bits of K2's u for that
vector.  A CUDA tensor in
a combination without a form raises; the plain versions compute every
combination the same way.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from gmres_tpu_torch.ops.blas import all_reduce
from gmres_tpu_torch.ops.cuda._build import (
    GRAM2_FORMS,
    SWEEP_FORMS,
    acc_dtype,
    check,
    form,
    library,
)

# K2's tile width (csrc/basis_sweep.cu: kGramTileCols) and the blocks per SM
# of its persistent grid (4 fit an SM; the fastest in the grid table of
# chip_smoke.py, PERF.md); K2x2 keeps two vectors in registers, so 2 fit
# (kGram2BlocksPerSM)
GRAM_TILE = 2048
GRAM_BLOCKS_PER_SM = 4
GRAM2_BLOCKS_PER_SM = 2


def _rows_ok(V: torch.Tensor, rows: int) -> None:
    if V.dim() != 2 or not 1 <= rows <= V.shape[0]:
        raise ValueError(f"rows={rows} outside 1..{V.shape[0]} for V of shape "
                         f"{tuple(V.shape)}")


def _sweep_args(name: str, V: torch.Tensor, rows: int, forms=SWEEP_FORMS, **vecs):
    """Validate the sweep's arguments (before anything is built): the
    (basis, vector) dtype form first, then every vector against the first
    one's dtype; return (library, suffix, m+1, n, number of blocks)."""
    _rows_ok(V, rows)
    w_dtype = next(iter(vecs.values()))[0].dtype
    sfx = form(name, forms, V.dtype, w_dtype)
    m1, n = V.shape
    check("V", V, V.dtype, (m1, n), V.device)
    for vname, (t, length) in vecs.items():
        check(vname, t, w_dtype, (length,), V.device)
    lib = library()
    if m1 > lib.max_rows:
        raise ValueError(f"{name}: basis height {m1} > {lib.max_rows}")
    return lib, sfx, m1, n, -(-n // lib.tile)


def _count(wrapper, sfx: str) -> None:
    """One launch of ``wrapper``'s kernel in the form ``sfx``."""
    wrapper.launches += 1
    wrapper.forms[sfx] += 1


def _combination(V, coef, rows: int, acc: torch.dtype) -> torch.Tensor:
    """sum_j coef[j] V[j] over the first ``rows`` rows, in ``acc``."""
    return torch.mv(V[:rows].to(acc).t(), coef[:rows].to(acc))


def gram_plain(V: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """u = V w over the first ``rows`` rows, summed in the accumulation
    dtype and rounded to w's."""
    _rows_ok(V, rows)
    acc = acc_dtype(w.dtype)
    u = torch.zeros(V.shape[0], dtype=w.dtype, device=V.device)
    u[:rows] = torch.mv(V[:rows].to(acc), w.to(acc)).to(w.dtype)
    return u


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """K2's launch geometry: fixed tiles of ``tile`` columns (the last may
    be partial), walked by a persistent grid of ``grid`` blocks, block b
    taking tiles b, b + grid, ..."""

    n: int
    tile: int
    n_tiles: int
    grid: int

    def tiles_of(self, block: int) -> range:
        return range(block, self.n_tiles, self.grid)

    def columns(self, t: int) -> range:
        return range(t * self.tile, min((t + 1) * self.tile, self.n))


def gram_plan(n: int, itemsize: int, sms: int, blocks_per_sm: int = GRAM_BLOCKS_PER_SM,
              threads: int = 256) -> GramPlan:
    """Tiles of GRAM_TILE columns (each thread covering GRAM_TILE / (threads
    x 16 / itemsize) 16-byte chunks of a basis row of ``itemsize``-byte
    values), and a grid of blocks_per_sm blocks on each SM, no more than
    there are tiles."""
    if GRAM_TILE % (threads * (16 // itemsize)):
        raise ValueError(f"K2: tile of {GRAM_TILE} columns for {threads} threads")
    n_tiles = -(-n // GRAM_TILE)
    return GramPlan(n=n, tile=GRAM_TILE, n_tiles=n_tiles,
                    grid=max(1, min(n_tiles, sms * blocks_per_sm)))


def tile_row_split(cols: int, phase: int, vec: int, threads: int = 256):
    """How K2's general form splits one row's tile of ``cols`` columns whose
    first 16-byte aligned column is ``phase``: (starts of the vec-column
    vector loads, columns read one by one); ``vec`` is the basis's values
    in 16 bytes (8 bf16, 4 fp32, 2 fp64).  Thread t reads head column t <
    phase and chunks phase + (u*threads + t)*vec for u < GRAM_TILE / (threads
    x vec), in scalars where a chunk crosses the tile's end."""
    vector, scalar = [], [c for c in range(min(phase, threads)) if c < cols]
    for k in range(GRAM_TILE // vec):
        cc = phase + k * vec
        if cc + vec <= cols:
            vector.append(cc)
        else:
            scalar += [c for c in range(cc, cc + vec) if c < cols]
    return vector, scalar


# K3 GRAM's stages (csrc/basis_sweep.cu: kUgSmemBudget, kUgLine,
# kUgMaxRowBytes, kUgBlocksPerSM): dynamic shared bytes of a block's two
# stages and u (225 KB of the 227 a block may have); tiles of whole 128-byte
# lines, at most 8 KB a row; up to 2 blocks an SM where the stages are small
UG_SMEM_BUDGET = 230_400
UG_LINE = 128
UG_MAX_ROW_BYTES = 8192
UG_BLOCKS_PER_SM = 2
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
UG_STATIC_BYTES = 128  # the kernel's static shared memory, rounded up


@dataclasses.dataclass(frozen=True)
class UpdateGramPlan(GramPlan):
    """K3 GRAM's launch geometry: GramPlan's tiles and persistent grid, the
    stride of the (rows, stride) tile partials (n_tiles rounded up to whole
    16-byte chunks of the accumulation dtype) and the dynamic shared bytes
    of a block (u's ``rows`` values in the accumulation dtype, the
    unrounded w' of a bf16 w, and a ring of two stages, each the tile's
    ``rows`` basis rows and w's tile)."""

    rows: int
    stride: int
    shared_bytes: int
    blocks_per_sm: int


def update_gram_plan(n: int, rows: int, itemsize: int, sms: int,
                     blocks_per_sm: int | None = None,
                     w_itemsize: int | None = None) -> UpdateGramPlan:
    """The widest tile of whole UG_LINE-byte lines of a basis row
    (``itemsize`` bytes a value) whose two stages, each ``rows`` basis rows
    and w's row (``w_itemsize``, by default the basis's), the unrounded w'
    of a bf16 w and u's ``rows`` values in whole 16-byte chunks of the
    accumulation dtype fit UG_SMEM_BUDGET, capped at UG_MAX_ROW_BYTES a
    basis row; as many blocks an SM as the stages leave room for, up to
    UG_BLOCKS_PER_SM (or ``blocks_per_sm``), no more than there are
    tiles."""
    w_itemsize = w_itemsize or itemsize
    acc = 8 if w_itemsize == 8 else 4
    vec, line = 16 // acc, UG_LINE // itemsize
    u_bytes = -(-rows // vec) * vec * acc
    per_col = 2 * (rows * itemsize + w_itemsize) + (acc if w_itemsize != acc else 0)
    fit = (UG_SMEM_BUDGET - u_bytes) // per_col // line * line
    tile = min(fit, UG_MAX_ROW_BYTES // itemsize)
    shared = u_bytes + tile * per_col
    per_sm = blocks_per_sm or min(
        UG_BLOCKS_PER_SM,
        SM_SHARED_BYTES // (shared + UG_STATIC_BYTES + BLOCK_RESERVED_BYTES))
    n_tiles = -(-n // tile)
    return UpdateGramPlan(n=n, tile=tile, n_tiles=n_tiles,
                          grid=max(1, min(n_tiles, sms * per_sm)), rows=rows,
                          stride=-(-n_tiles // vec) * vec, shared_bytes=shared,
                          blocks_per_sm=per_sm)


_SMS: dict = {}
_TICKETS: dict = {}
_STREAMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a card, read once a process."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _gram_state(device: torch.device):
    """(SM count, the zeroed ticket counter) of a card in this process.  K2,
    K2x2, K3 GRAM, K10 and the residual modes of K1 and K12 share the
    counter: each kernel's last block resets it, so two of them must never
    run at once.  They are therefore held to the stream the counter was
    made on, and a launch from any other stream raises.  Each process makes
    its own counter, so ranks that share a card share none."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device not in _TICKETS:
        _TICKETS[device] = torch.zeros(1, dtype=torch.int32, device=device)
        _STREAMS[device] = stream
    if stream != _STREAMS[device]:
        raise RuntimeError(
            f"K2/K2x2/K3 GRAM/K10 and the K1/K12 residual share one ticket counter on "
            f"{device}, made on stream {_STREAMS[device]:#x}; launching from stream "
            f"{stream:#x} could interleave two kernels' tickets")
    return sm_count(device), _TICKETS[device]


def gram_cuda(V: torch.Tensor, w: torch.Tensor, rows: int,
              blocks_per_sm: int | None = None) -> torch.Tensor:
    """K2: u = V w in one launch (the last block adds the tiles' partials);
    ``blocks_per_sm`` overrides GRAM_BLOCKS_PER_SM.  The bits do not depend
    on the grid."""
    lib, sfx, m1, n, _ = _sweep_args("gram", V, rows, w=(w, V.shape[1]))
    sms, ticket = _gram_state(V.device)
    plan = gram_plan(n, V.element_size(), sms, blocks_per_sm or GRAM_BLOCKS_PER_SM,
                     lib.threads)
    u = torch.empty(m1, dtype=w.dtype, device=V.device)
    partials = torch.empty(rows * plan.n_tiles, dtype=acc_dtype(w.dtype), device=V.device)
    lib.call(f"gmres_basis_gram_{sfx}", V.data_ptr(), w.data_ptr(), u.data_ptr(),
             partials.data_ptr(), ticket.data_ptr(), n, rows, m1, plan.tile, plan.n_tiles,
             plan.grid)
    _count(gram_cuda, sfx)
    gram_cuda.grid = plan.grid
    return u


gram_cuda.launches = 0
gram_cuda.forms = Counter()
gram_cuda.grid = 0


def gram2_plain(V: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, rows: int):
    """[V w0, V w1] as gram_plain computes each, the columns of one (m+1, 2)
    tensor."""
    return torch.stack([gram_plain(V, w0, rows), gram_plain(V, w1, rows)], dim=1)


def gram2_cuda(V: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, rows: int,
               blocks_per_sm: int | None = None) -> torch.Tensor:
    """K2x2: [V w0, V w1] in one launch of K2's kernel with two vectors, V
    read once, as the columns of one contiguous (m+1, 2) tensor in the
    accumulation dtype (w0's for every form it has); each column has the
    bits of gram_cuda's u for that vector (the same tiles and sums;
    ``blocks_per_sm`` overrides GRAM2_BLOCKS_PER_SM and the bits do not
    depend on it)."""
    lib, sfx, m1, n, _ = _sweep_args("gram2", V, rows, GRAM2_FORMS, w0=(w0, V.shape[1]),
                                     w1=(w1, V.shape[1]))
    sms, ticket = _gram_state(V.device)
    plan = gram_plan(n, V.element_size(), sms, blocks_per_sm or GRAM2_BLOCKS_PER_SM,
                     lib.threads)
    u = torch.empty((m1, 2), dtype=w0.dtype, device=V.device)
    partials = torch.empty(rows * 2 * plan.n_tiles, dtype=acc_dtype(w0.dtype), device=V.device)
    lib.call(f"gmres_basis_gram2_{sfx}", V.data_ptr(), w0.data_ptr(), w1.data_ptr(),
             u.data_ptr(), partials.data_ptr(), ticket.data_ptr(), n, rows, m1, plan.tile,
             plan.n_tiles, plan.grid)
    _count(gram2_cuda, sfx)
    return u


gram2_cuda.launches = 0
gram2_cuda.forms = Counter()


def update_plain(V, w, u, rows: int):
    """w - u^T V over the first ``rows`` rows, in the accumulation dtype,
    rounded to w's."""
    _rows_ok(V, rows)
    acc = acc_dtype(w.dtype)
    return (w.to(acc) - _combination(V, u, rows, acc)).to(w.dtype)


def update_cuda(V, w, u, rows: int):
    """K3 with both flags off: w - u^T V."""
    lib, sfx, m1, n, _ = _sweep_args("update", V, rows, w=(w, V.shape[1]), u=(u, V.shape[0]))
    w1 = torch.empty_like(w)
    lib.call(f"gmres_basis_update_{sfx}", V.data_ptr(), w.data_ptr(), u.data_ptr(),
             w1.data_ptr(), n, rows, m1)
    _count(update_cuda, sfx)
    return w1


update_cuda.launches = 0
update_cuda.forms = Counter()


def update_gram_plain(V, w, u, rows: int):
    """(w', V w') with w' = w - u^T V: u2 from w' before it is rounded to
    w's dtype (``orth_kernel.py:144-160``)."""
    _rows_ok(V, rows)
    acc = acc_dtype(w.dtype)
    w1 = w.to(acc) - _combination(V, u, rows, acc)
    return w1.to(w.dtype), gram_plain(V, w1, rows).to(w.dtype)


# K3 GRAM in fp64: dynamic shared bytes a block requests, and does not use,
# so that two blocks share an SM and the tiles its GRAM pass reads again are
# still in L2 (csrc/basis_sweep.cu: basis_update_gram_blocks_kernel): 0.1701
# ms at 31 rows where 0 took 0.1976 (chip_smoke.py on the H100, PERF.md, section 6)
UG_F64_PAD = 100_000


def update_gram_cuda(V, w, u, rows: int, blocks_per_sm: int | None = None):
    """K3 GRAM: (w - u^T V, V (w - u^T V)).  fp32 and the mixed forms:
    one launch, each basis tile read from device memory once (the last
    block adds the tiles' partials); ``blocks_per_sm`` overrides the plan's,
    and the bits do not depend on the grid.  fp64: the one-row-at-a-time
    arithmetic and bits, block partials added by torch.sum
    (``blocks_per_sm`` does not apply)."""
    lib, sfx, m1, n, nb = _sweep_args("update_gram", V, rows, w=(w, V.shape[1]),
                                      u=(u, V.shape[0]))
    w1 = torch.empty_like(w)
    if sfx == "f64":
        partials = torch.empty((nb, m1), dtype=V.dtype, device=V.device)
        lib.call("gmres_basis_update_gram_f64", V.data_ptr(), w.data_ptr(), u.data_ptr(),
                 w1.data_ptr(), partials.data_ptr(), n, rows, m1, UG_F64_PAD)
        _count(update_gram_cuda, sfx)
        update_gram_cuda.grid = nb
        return w1, partials.sum(dim=0)
    sms, ticket = _gram_state(V.device)
    plan = update_gram_plan(n, rows, V.element_size(), sms, blocks_per_sm, w.element_size())
    u2 = torch.empty(m1, dtype=w.dtype, device=V.device)
    partials = torch.empty(rows * plan.stride, dtype=acc_dtype(w.dtype), device=V.device)
    lib.call(f"gmres_basis_update_gram_{sfx}", V.data_ptr(), w.data_ptr(), u.data_ptr(),
             w1.data_ptr(), u2.data_ptr(), partials.data_ptr(), ticket.data_ptr(), n, rows,
             m1, plan.tile, plan.n_tiles, plan.stride, plan.grid, plan.shared_bytes)
    _count(update_gram_cuda, sfx)
    update_gram_cuda.grid = plan.grid
    return w1, u2


update_gram_cuda.launches = 0
update_gram_cuda.forms = Counter()
update_gram_cuda.grid = 0


def update_sumsq_plain(V, w, u, rows: int):
    """(w', ||w'||^2) with w' = w - u^T V: the sum of squares of w' before
    it is rounded to w's dtype, in the accumulation dtype
    (``orth_kernel.py:192-207``)."""
    _rows_ok(V, rows)
    acc = acc_dtype(w.dtype)
    w2 = w.to(acc) - _combination(V, u, rows, acc)
    return w2.to(w.dtype), torch.dot(w2, w2)


def update_sumsq_cuda(V, w, u, rows: int):
    """K3 with SUMSQ: (w - u^T V, ||w - u^T V||^2) in one sweep, the sum of
    squares in the accumulation dtype."""
    lib, sfx, m1, n, nb = _sweep_args("update_sumsq", V, rows, w=(w, V.shape[1]),
                                      u=(u, V.shape[0]))
    w2 = torch.empty_like(w)
    partials = torch.empty(nb, dtype=acc_dtype(w.dtype), device=V.device)
    lib.call(f"gmres_basis_update_sumsq_{sfx}", V.data_ptr(), w.data_ptr(), u.data_ptr(),
             w2.data_ptr(), partials.data_ptr(), n, rows, m1)
    _count(update_sumsq_cuda, sfx)
    return w2, partials.sum()


update_sumsq_cuda.launches = 0
update_sumsq_cuda.forms = Counter()


def gram(V, w, rows: int):
    return gram_cuda(V, w, rows) if V.is_cuda else gram_plain(V, w, rows)


def gram2(V, w0, w1, rows: int):
    return gram2_cuda(V, w0, w1, rows) if V.is_cuda else gram2_plain(V, w0, w1, rows)


def update(V, w, u, rows: int):
    return update_cuda(V, w, u, rows) if V.is_cuda else update_plain(V, w, u, rows)


def update_gram(V, w, u, rows: int):
    return update_gram_cuda(V, w, u, rows) if V.is_cuda else update_gram_plain(V, w, u, rows)


def update_sumsq(V, w, u, rows: int):
    return (update_sumsq_cuda(V, w, u, rows) if V.is_cuda
            else update_sumsq_plain(V, w, u, rows))


def cgsr2(V, w, rows: int, comm=None):
    """One CGSR step (two CGS passes) in three basis sweeps:

        u1 = V w;  (w1, u2) = update_gram;  (w2, ss) = update_sumsq

    Returns (h = u1 + u2, w2, ||w2||) in w's dtype, the norm taken from
    the sum of squares of w2 before it is rounded (``orth_kernel.py:
    cgsr2_pallas``).  With ``comm`` each sweep's
    reduction (u1, u2, ss) is summed over the ranks before the next sweep
    uses it (``orth_kernel.py:248-256``)."""
    u1 = all_reduce(gram(V, w, rows), comm)
    w1, u2 = update_gram(V, w, u1, rows)
    u2 = all_reduce(u2, comm)
    w2, ss = update_sumsq(V, w1, u2, rows)
    return u1 + u2, w2, torch.sqrt(all_reduce(ss, comm)).to(w.dtype)
