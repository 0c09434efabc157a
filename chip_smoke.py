#!/usr/bin/env python3
"""On-card smoke run of gmres_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py
    python3 chip_smoke.py --k6 [--parent DIR]   # K6's section alone, and
                                                # K6 beside DIR's K6

It builds the port's CUDA kernels (and the host helper of the ILU
preconditioners) from the sources in the checkout and drives eight paths,
a phase of the command-line entry points and a batched phase,
the first five through ``gmres_tpu_torch.stage`` and ``solve`` in the
``baseline`` and ``mixed`` modes (x_true = rand_vect(n, 42), b = A x_true
in fp64 numpy, CGSR unless said otherwise, restart length 30, tol 1e-8):

1. the banded path: ``convection_diffusion_2d(1024, beta=2.0)`` (n =
   1,048,576, 5 DIA bands), identity preconditioner, kernels K1-K4, the
   reference's 26/780 history;
2. the unstructured path: ``unstructured_mesh(1024*1024, run=8)`` (mesh3d,
   25,151,458 nonzeros, which DIA refuses), staged as SELL, identity
   preconditioner, kernels K5 and K2-K4, the reference's 1/30 history;
3. the ILU path (convdiff-ilu): the same convdiff@1M operator with M built
   on the host from the CSR matrix and passed as ``M=``: ILU-Jacobi(3) (DIA
   factors, K1 per sweep; the reference's 54/1620 baseline and 63/1890
   mixed; the baseline count also held to the same solve with K2's plain
   version in its place, and logged beside the same solve with K3 GRAM's
   plain version in its place), exact ILU (K6; converges, backward error <=
   1e-8), and exact ILU
   on ``convection_diffusion_2d(512, beta=2.0)`` (the reference's 8/240 in
   mixed).  The fused K6 form serves 262K and the segmented one 1M fp64;
3b. the bf16 ILU path (convdiff-bf16ilu): ILU-Jacobi(3) built in bf16 (its
   bands swept in plain torch), its apply held to the CPU's and timed
   beside K1; at convdiff@1M the bf16 tier (CGSR, sequential MGS: the bf16
   phase, the stall, the fp32 continuation) and fp32 inner with the bf16 M,
   each converging with its counts in a window of the card's own, CGSR
   also on its sweeps' plain versions, held to the kernels' counts; the
   same at convdiff(256) held to the JAX package's counts on the CPU
   (``scripts/port_bf16ilu_cpu.py``); bf16 exact ILU at 262K on its sweep
   form (never K6), its apply's wall and device time beside K6 fp32's and a
   solve cut at 3 restarts held to the JAX package's history; and the
   route bf16 exact ILU takes at 1M.  K1, K2-K4 and K7 launch, in their
   (bf16, bf16) and fp32 forms, and no K5, K6, K2x2 or K8-K12;
4. the MGS and policy path (convdiff-mgs): the same convdiff@1M operator,
   identity preconditioner, with ``orth="mgs"`` sequential (K7) and ICWY
   (K2x2 and K3 SUMSQ) in both modes (the reference's 26/780), and in mixed
   CGSR under the relres (787), orthloss (780, K2 in the loss recurrence)
   and repeat policies (the reference aborts at 80 restarts of 7
   iterations) and CGSR with ``orth_steps=3`` (K3 plain mode);
5. the df64 path (convdiff-df64): the same convdiff@1M operator in mode
   ``df64`` (the inner loop on (hi, lo) fp32 pairs), identity
   preconditioner: CGSR (the reference's 26/780), CGS, and MGS sequential
   and ICWY (the reference's 26/780 for MGS), through K8 (pair DIA SpMV),
   K9-K11 (pair sweeps) and K4's pair mode, timed interleaved with the
   baseline CGSR solve; then two small phases on the card: the NaN fp64
   fallback (the n = 32 overflow matrix of tests/test_aux.py, mixed) and a
   checkpointed mixed CGSR solve aborted at 12 restarts and resumed;
6. the distributed path (convdiff-dist): the same convdiff@1M problem split
   over 4 gloo ranks spawned on this one card (``gmres_tpu_torch.parallel.
   launch.spawn``; the kernels are built here first and the ranks load
   them), each rank calling ``solve_distributed``: the distributed dryrun,
   CGSR in both modes (the reference's 26/780; x within 1e-6 of the first
   path's single-card x), mixed MGS under the ``low_sync_mgs=None`` rule,
   MGS sequential and ICWY interleaved (cut at 4 restarts) and ILU-Jacobi(3)
   mixed at ``convection_diffusion_2d(512)``, through K12 (a rank's halo DIA
   SpMV and, in residual mode, its outer residual); then the precision
   tiers: mixed-cb and baseline-cb CGSR (30..40 and 26..28 restarts;
   mixed-cb's cycles and x against a single-card solve) and
   MGS (ICWY, cut at 4 restarts), df64 CGSR (26/780; x against a
   single-card solve) and MGS ICWY and sequential (cut at 4), through
   K9-K11 and K12 in fp64, no K8, and the bf16 tier with Jacobi and a bf16
   ILU-Jacobi(3) at 262K, cut at 6 restarts, never escalating, beside the
   single card's bf16 cycles; then the block-Jacobi ILU(3)
   (``precond="bilu_jacobi"``, its DIA factor sweeps on K1) CGSR in both
   modes at 1M (a window of restarts) and at 262K (the JAX package's CPU
   counts, ``scripts/port_bilu_cpu.py``), the per-rank SELL route on
   mesh3d@1M (K5, its outer residual on K5's rank form; the TPU's 1/30, x
   against the second path's), a checkpointed mixed CGSR solve cut at 12
   restarts and resumed (26/780, the uninterrupted solve's bits; df64 the
   same, cut short) and mixed CGSR with ``multihost=True``; per-host
   input: convdiff@1M written to the cli phase's ``.mtx`` here, each rank
   loading its own rows (``load_matrix_rows``) and solving mixed CGSR with
   identity and with the block-Jacobi ILU(3) (the whole-matrix solves'
   counts and x, bit for bit); and ``cli.solve.main(["--dist", ...])`` on
   the ranks at that file (rank 0 prints, the others nothing); each case's
   launches held to ``dist_case_kernels``;
7. the compressed-basis and bf16 path (convdiff-cb): the dtype forms of
   K2, K2x2, K3 (three modes), K7 and K4 held to their plain versions at
   convdiff@1M's shapes, K2's and K3 GRAM's forms counted one device kernel
   a call in a fresh process; then on the convdiff@1M operator mixed with a
   bf16 basis (30..40 restarts; the TPU's 35/1050) and baseline with an fp32
   basis (26..28), both with sequential MGS and ICWY too, short solves that
   launch the remaining forms, mesh3d@1M mixed with a bf16 basis, and the
   bf16 inner tier with its stall escalation to fp32, once; the four
   interleaved walls of mixed, mixed-cb, baseline and baseline-cb, and the
   bf16 DIA SpMV (plain torch) beside K1 in fp32.

Then the cli phase: the reference-format entry points at convdiff@1M, each
through the function a user calls: the matrix written by
``io.mmio.write_coordinate`` and read back by ``load_matrix`` to the same
arrays (x_true and b through ``write_array`` and ``load_vector``); three
runs of ``cli.solve.main`` at that file (mixed and baseline with
``--bpath``, CGSR identity, within one restart of 26/780, the summary block
parsed by the reference's regex; the reference's defaults, MGS and exact
ILU, in mixed, equal in counts to the same ``solve`` called directly; the
CGSR runs launch K1, its residual mode, K2, K3 GRAM and SUMSQ and K4, the
defaults K1, its residual mode, K7, K6 fused and K4; K1 in fp32 in mixed
and fp64 in baseline; no K8-K12); the block that ``cli.solve.main`` with
``--dist`` printed on rank 0 of the distributed path's ranks, held to the
single-device block (26/780); ``cli.condest_cli.main`` as the TPU
campaign ran it, on convdiff:1024 (K1 fp64 only; sigma_max held to the
TPU's, t and the LSQR wall a step logged with whether the run was capped)
and mesh3d:262144 (K5 fp64 only; t and sigma_max held to the TPU's, cond
to an extended-precision estimate), each operator's product held to its
plain version first; ``experiments.sweep.main`` over the ``.mtx``
(baseline and mixed rows within one restart of 26/780) and
``experiments.findmin.main`` on its history.  Each entry point's launches
are read around its own call (counts set to 0 just before it), so the
direct ``solve`` and the operators' checks count for nothing.

Then the batched phase: K1's lane form at 1, 2, 4 and 8 lanes (every width
a launch takes), fp32 and fp64, in both modes, each lane bit for bit
against K1 on that lane, timed beside its bound and torch.sparse.mm of the
CSR matrix by the (n, s) block; ``solve_batched`` at convdiff@1M (x_true_j
= rand_vect(n, 40 + j), CGSR, Jacobi) at s = 8 in mixed and baseline, each lane
converged within one restart of 26/780 with the counts of the port's
``solve`` of its b and a backward error <= 1e-8, the batched wall beside
the sequential solves' (one each, after a batched warm-up); a few cycles of the s
= 8 mixed solve traced in a fresh process (``batched_trace``: host wall and
device busy time a step, device time by kernel); ``cli.bench_kernels``
in-process, its K1, K2 and K3 times held to its own timer's on this
script's operands; and
``experiments.analysis`` on the cli phase's sweep rows.  The batched solves
must launch K1's lane form in both modes, K2, K3 GRAM, K3 SUMSQ and K4, and
no other kernel.

Before each path's solves it holds each of the path's kernels against its
plain PyTorch version at the path's shapes (fp32 and fp64; a 31-row Krylov
basis) and times both (the card kept busy while the host enqueues the
timed call, so that the events hold device time), beside the kernel's
bound (the larger of its bytes over the copy yardstick, its operations
over the card's peak, and for K6 its levels' barriers times one measured
empty barrier of the same sync) and, where one PyTorch call computes the
same function, that call's time (K6: two CSR torch.triangular_solve
calls).  K2 is also timed on 1-4 blocks per SM and K3 GRAM in fp32 on
its plan's, 2 and 3 blocks per SM (the same bits on each), and each is
shown to be one device kernel a call; K2x2 (K2's kernel with two vectors)
is one device kernel a call, and its u0 and u1 are K2's u of each vector
bit for bit (fp32, fp64 and its two dtype forms, at 31 and 16 rows); K3
GRAM in fp64 (its block partials added by torch.sum: two) under three caps
of its blocks an SM, the same bits each; K3 GRAM's w' equals K3 SUMSQ's; K1
(plain and residual modes) on several grids, y, r and the two sums the same
bits on each, and its residual mode and residual lane form (s = 1, 2, 4, 8)
one device kernel a call (counted in a fresh process); K6
is held bit for bit to its plain version, fused and segmented to each
other, and timed on one block and on cooperative grids beside the empty
barrier of each sync candidate (clusters too) and the old design's floor,
and at convdiff(2048) (widest level 2048) on each of its forms.
Each path's launch counts are reset just
before its solves and read just after: the path's own kernels must launch,
the other paths' SpMV kernels, (without ILU) K6, (without MGS, a policy
or orth_steps != 2) the MGS kernels, (outside the df64 and distributed
paths) K8-K11 and (outside the distributed path) K12 must not; on the df64
path K1's plain mode, K2, K3, K2x2 and K7 must not; each distributed rank
must launch K12 in both modes, K9-K11, every tier's dtype forms and K5's
rank form, and each distributed case K1 only with the block-Jacobi ILU, K5
only on the SELL route, K12 on the halo route, and never K1's residual
mode, K6, K7 or K8.
Any failed check raises and the script exits non-zero; without a CUDA
device it exits non-zero at once.  Each phase prints its seconds.

Output: the card's name and power limit, versions, build time, per-kernel
error, timing and bound lines, per-path build/stage and per-mode solve
lines, K2's and K3 GRAM's grid tables, K6's sync candidates, the
exact-ILU solve walls,
K7's grid-size table and the sequential-vs-ICWY MGS walls, the
df64 step and solve walls, the distributed solves and walls beside the
single card's, the compressed-basis and bf16 solves and walls, the cli
phase's outputs, times and launches; the batched
phase's kernel lines, solves, walls, trace and tools; then one
JSON line with the 19 kernels (launch counts from the solves, the
distributed ones summed over the ranks; measured errors and times, bounds,
one-call times; the dtype forms as variants with their launches on the
convdiff-cb path, K1's lane forms as variants of K1's two modes with their
launches in the batched phase);
then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

NX = 1024          # n = NX^2 = 1,048,576 rows, 5,238,784 nonzeros
RLEN = 30
TOL = 1e-8
MAX_RESTARTS = 80
TPU_ITERS = 780    # the reference's history on convdiff (BENCH_r05.json)
# the reference's history on mesh3d@1M (results/round5/bench_mesh3d.txt),
# both modes: (restarts, iterations)
MESH_TPU_HISTORY = (1, 30)
REPS = 20          # timed launches per kernel and per plain version
GUARD_CYCLES = 400_000  # ~0.2 ms of the card spinning before each timed call
# the kernels each path's SpMV runs; K2-K4 (the basis sweeps and the update)
# serve every path, K6 only the ILU path
PATH_KERNELS = {"convdiff": ("dia_spmv", "dia_residual"),
                "mesh3d": ("sell_spmv", "sell_residual")}
ILU_KERNELS = ("ilu_trisolve_fused", "ilu_trisolve_segmented")
# the reference's ILU histories (restarts, iterations): ILU-Jacobi(3) at
# convdiff@1M (results/round4/bench_ilujacobi.txt), exact ILU in mixed at
# convection_diffusion_2d(512, beta=2.0) (results/round5/bench_ilu_exact.txt)
ILU_JACOBI_HISTORY = {"baseline": (54, 1620), "mixed": (63, 1890)}
EXACT_262K_HISTORY = (8, 240)
# Restart bounds for ILU-Jacobi(3) at convdiff@1M.  The iteration stalls
# just above the tolerance for its last restarts, so the rounding of the
# basis sweeps picks the count.  Baseline: from 2 below the reference's 54
# to 1 above, and the count must equal that of the same solve with K2's
# plain version (torch.mv) in its place, in the same run.  The one-launch K2
# takes 52 restarts where the per-block partials and torch.sum it replaced
# took 54; torch.mv's order and a compensated (near-exact) K2 take 52 too
# (scripts/port_k2.py, one card; PERF.md, section 6).  Mixed: from 3 below
# the fp64 baseline's 54 to 1 above the reference's 63 (on the CPU the JAX
# package and the port, identical in baseline, differ in mixed by 1 restart
# at convection_diffusion_2d(128) and by 3 at (256), the port lower).
ILU_JACOBI_RESTARTS = {"baseline": (52, 55), "mixed": (51, 64)}
NX_262K = 512
TRISOLVE_REPS = 5        # timed K6 launches (one apply is ~4000 dependent sweeps)
TRISOLVE_PLAIN_REPS = 2  # the plain version is thousands of torch launches
# the reference's histories on the MGS/policy path (restarts, iterations):
# sequential and ICWY MGS (results/round5/bench_mgs_seq.txt,
# results/round4/bench_mgs_lowsync.txt), relres(1e-2) and orthloss(1e-2)
# (BASELINE.md:132-133); repeat(1e-2) aborts at 80 restarts of 7 iterations
# each (BASELINE.md:136-146)
# the bf16 ILU path (convdiff-bf16ilu): ILU-Jacobi(3) built in bf16.  At
# convdiff(BF16ILU_NX) the card's counts are held to the JAX package's on
# the CPU (scripts/port_bf16ilu_cpu.py --nx 256, the JAX route; (restarts
# before the escalation, all restarts), by (tier, orth)): the bf16 phase
# within STALL_WINDOW, the total within BF16ILU_SLACK.  On the CPU at that
# size the port's totals were 63, 69, 56 against these: the slow tail moves
# with the sums' order by up to 5, ~10% of it; the card sums in yet another
# order, so twice that
BF16ILU_NX = 256
BF16ILU_CPU = {("bf16", "cgsr"): (9, 63), ("bf16", "mgs"): (9, 66), ("fp32", "cgsr"): (51, 51)}
STALL_WINDOW = 6
BF16ILU_SLACK = 10
# at convdiff@1M, where the JAX package is not run on a CPU, the card's own
# counts (the same on every run): every solve must converge within
# BF16ILU_MAX_RESTARTS and hold these within STALL_WINDOW and
# BF16ILU_SLACK.  CGSR on the plain versions of its sweeps (torch.mv) is
# held to the kernels' counts: at convdiff(BF16ILU_NX) within BF16ILU_SLACK,
# at 1M, after the bf16 stall, with its fp32 tail crawling near the
# tolerance for ~90 restarts at a rate the rounding sets, within
# BF16ILU_PLAIN_1M (the H100 read 139 against the kernels' 111)
BF16ILU_1M = {("bf16", "cgsr"): (18, 111), ("bf16", "mgs"): (26, 127),
              ("fp32", "cgsr"): (115, 115)}
BF16ILU_PLAIN_1M = 35
BF16ILU_MAX_RESTARTS = 200
# bf16 exact ILU at convdiff(512): a solve cut at this many restarts, its
# backward error per cycle held within BF16_EXACT_FACTOR of the JAX
# package's on the CPU (scripts/port_bf16ilu_cpu.py --nx 512
# --exact-restarts 3; the port's route on the CPU read 1.0036, 1.229e-05,
# 2.289e-06: 2,046 bf16 sweeps an apply round apart, 1.42x at the third)
BF16_EXACT_CUT = 3
BF16_EXACT_CPU = (1.0035820661989343, 1.2273713204590937e-05, 1.614626464391044e-06)
BF16_EXACT_FACTOR = 4.0
MGS_HISTORY = (26, 780)
POLICY_ITERS = {"relres": 787, "orthloss": 780}
REPEAT_HISTORY = (80, 560, 7)
MGS_KERNELS = ("basis_mgs", "basis_gram2", "basis_update")
DF64_KERNELS = ("dia_spmv_df64", "df_gram", "df_update_gram", "df_update_sumsq")
# the kernels a df64 solve on DIA must not launch: K1 plain mode, K2, K3
# (every mode), K2x2, K7
DF64_IDLE = ("dia_spmv", "basis_gram", "basis_update_gram", "basis_update_sumsq",
             "basis_update", "basis_gram2", "basis_mgs")
# published peaks of one H100 SXM outside the tensor cores (NVIDIA's data
# sheet, 700 W): the operations term of a kernel's bound.  "df64": the
# error-free-transform chains are fp32 adds and multiplies, not FMAs, so
# they are counted as instructions against half the 67 TFLOP/s FMA peak.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "df64": 33.5e12}
# fp32 instructions of a pair product plus a pair sum (df64.cuh: df_mul 10,
# df_add 11, rounded to 20), per (row, column) and sweep
DF_OPS = 20
SYNC_PROBE = 2000      # barriers per timed empty cooperative launch
GRAM_GRID_BLOCKS_PER_SM = (1, 2, 3, 4)   # K2 grids measured
K1_GRIDS_PER_SM = (1, 4)                 # K1 grids held to the same bits
UG_GRID_BLOCKS_PER_SM = (None, 2, 3)     # K3 GRAM fp32 grids measured (None: its plan's)
UG_F64_PADS = (0, 100_000, 200_000)      # K3 GRAM fp64 occupancy caps measured (bytes)
DF_UG_TILES = (None, 224, 128)           # K10 tiles measured (None: its plan's)
DF_UG_BLOCKS_PER_SM = (1, 2, 3)          # K10 grids measured, at each tile
# K6's sync candidates (mode, blocks of 1024 threads), each empty barrier
# measured, and the kernel timed at convdiff@1M on those of its own two
# forms (one block, a cooperative grid; the kernel has no cluster form)
LEVEL_SYNCS = (("block", 1), ("cluster", 2), ("cluster", 4), ("cluster", 8), ("grid", 8),
               ("grid", 132))
# K6's form table: convdiff(NX_WIDE) (widest level 2048 rows) fused on each
# form; and the turns of K6 timed beside another checkout's (--parent)
NX_WIDE = 2048
K6_FORMS = (("block", 1), ("grid", 2), ("grid", 4), ("grid", 8), ("grid", 132))
K6_BESIDE_PAIRS = 4
# Kernel vs plain tolerance, relative to the same computation on absolute
# values (the scale of the standard summation error bound): the two sum in
# different orders (per-block partials, FMA contraction) over up to n terms.
# A double-float pair carries ~2^-48; its sums are held to 2^-46.
TOL_REL = {"float32": 1e-5, "float64": 1e-13, "df64": 2.0 ** -46}
# A bf16 output is an fp32 sum rounded to bf16: the kernel's and the plain
# version's sums may differ by TOL_REL["float32"] of their scale and then
# round one bf16 ulp apart, which is at most 2^-7 of the value itself.
BF16_ULP = 2.0 ** -7
# the compressed-basis and bf16 path (convdiff-cb): the forms are those of
# _build.SWEEP_FORMS, GRAM2_FORMS and AXPY_FORMS that the native paths do not
# launch (cb_forms); their inputs are an Arnoldi step's, w = V^T c + e with
# |e| CB_NOISE of |V^T c| elementwise (in rms), so that the projection is most
# of w and a sweep that skips it fails
CB_NOISE = 0.5
# K7 under a bf16 w rounds w after every row; a rounding that flips one ulp
# in one row carries to w', so w' is held to CB_MGS_FLIPS flips of the largest
# value the element takes (one element in a million flipped once in a CPU
# trial of fp64-ordered sums at these shapes)
CB_MGS_FLIPS = 2
# restart bounds at convdiff@1M, CGSR: the bf16 basis under mixed (the TPU
# reference's 35/1050, results/round4/bench_cb.txt) and the fp32 basis under
# baseline (the uncompressed 26/780, up to two restarts more)
CB_RESTARTS = {"mixed-cb": (30, 40), "baseline-cb": (26, 28)}
CB_CUT = 3             # restarts of the solves that only launch a form
# a CB_CUT-restart solve's backward error ||b - Ax|| / (||b|| + ||A||_F ||x||)
# is held within this factor of the full CGSR solve of its tier after as
# many restarts (the history's per-cycle value)
CB_CUT_FACTOR = 4.0
# the bf16 inner tier at convdiff@1M: the restarts before it stalls and
# escalates (28 on the H100), the best backward error its bf16 cycles
# reach (2.6e-8 there; a bf16 loop floors near 1e-6) and at most the fp32
# solve's 26 restarts after the escalation
CB_BF16_STALL = (14, 56)
CB_BF16_BEST = 1e-6
CB_BF16_AFTER = 26
CB_WALL_REPS = 1       # timed solves of mixed, mixed-cb, baseline, baseline-cb, after a warm-up
# the df64 path: the reference's CGSR df64 history at convdiff@1M
# (results/round4/bench_df64.txt:7) and MGS (results/round5/bench_mgs_seq.txt)
DF64_HISTORY = (26, 780)
DF64_WALL_REPS = 1     # timed solves per form, after a warm-up
# the distributed path (convdiff-dist): gloo ranks sharing the card, each
# owning a block of rows of convdiff@1M
DIST_RANKS = 4
DIST_KERNELS = ("dia_spmv_halo", "dia_residual_halo")
# what no distributed solve launches: K1's residual mode, K6, K7 (distributed
# sequential MGS is a plain row loop with one collective a row) and K8 (a
# rank's df64 SpMV is merge, an fp64 SpMV and split; its df64 sweeps K9-K11)
DIST_NEVER = ("dia_residual", *ILU_KERNELS, "basis_mgs", "dia_spmv_df64")
# MGS sequential against ICWY, mixed: this many solves of each (interleaved
# when more than one), cut at DIST_MGS_RESTARTS restarts, after a warm-up
# of each cut at one restart (a step's wall is what the rule needs;
# a whole sequential solve takes ~50 s there, PERF.md; the repeats and
# restarts of the earlier paths are cut to make room for the block-Jacobi
# ILU, SELL-route, checkpoint and per-host cases, PERF.md section 4)
DIST_MGS_REPS = 1
DIST_MGS_RESTARTS = 2
# the block-Jacobi ILU(3) (precond="bilu_jacobi"), CGSR, at convdiff@1M in
# both modes: each converges (backward error <= 1e-8) within this window
# of restarts, written before the first card reading (PERF.md section 6):
# ILU-Jacobi(3) takes 52-54 / 51-64 there, and the block form drops
# the couplings across three block edges of 262,144 rows
BILU_RESTARTS = (45, 80)
# at convdiff(NX_262K) over DIST_RANKS ranks the card's counts are held to
# the JAX package's solve_distributed on a 4-device CPU mesh
# (scripts/port_bilu_cpu.py --nx 512; (restarts, iterations) by mode)
# within BILU_SLACK restarts: the port's route on the CPU reads 40/1200 in
# both modes, its baseline history equal to the JAX package's to 1e-6
# relative for 20 cycles, then both oscillating between 1e-8 and 4e-8
# (--history), where the rounding picks the count
BILU_CPU = {"baseline": (38, 1140), "mixed": (38, 1140)}
BILU_SLACK = 6
# Mixed: the JAX package's fp32 sums and the port's part by 1e-3 in the
# first cycles and from cycle ~17 every history runs a sawtooth between
# 7e-9 and 3.4e-7 whose dips under the tolerance the fp32 rounding picks.
# The card read 53 after the window above was written; the witness of
# scripts/dist_bilu_seeds.py and port_bilu_cpu.py --seeds (PERF.md
# section 6) reads, at x_true seeds 42, 7, 1234: the JAX package on the
# CPU 38, 48, 30, the port on the CPU 40, 46, 50, the card's kernels 53,
# 46, 42 and the card's plain versions 46, 52, 40, each route the same
# twice: two CPU routes with no kernel part by 20 at one seed.  So each
# mode's first BILU_CYCLES cycles are held to the JAX package's
# (BILU_CPU_CYCLES, from --history) within BILU_CYCLE_REL (every route
# and seed read within 1.3e-3), and the mixed count within
# BILU_MIXED_SLACK above its 38
BILU_CYCLES = 12
BILU_CPU_CYCLES = {
    "baseline": (1.523511e-05, 4.227387e-06, 3.096817e-06, 1.247084e-06, 1.663053e-06,
                 6.493031e-07, 6.894787e-07, 5.469587e-07, 4.151706e-07, 4.467144e-07,
                 3.15447e-07, 3.369102e-07),
    "mixed": (1.524849e-05, 4.231008e-06, 3.099379e-06, 1.248191e-06, 1.664348e-06,
              6.499199e-07, 6.900518e-07, 5.474567e-07, 4.155411e-07, 4.470741e-07,
              3.157845e-07, 3.371972e-07)}
BILU_CYCLE_REL = {"baseline": 1e-5, "mixed": 3e-3}
BILU_MIXED_SLACK = 20
# the per-rank SELL route on mesh3d@1M (mixed CGSR, identity): the TPU's
# 1/30 (results/round5_bench_dist.txt:8, its 1-device mesh SELL solve), x
# within this of the single card's mesh3d mixed x, relative: one cycle of
# fp32 Arnoldi steps whose sums round apart over the ranks (TOL_REL's fp32
# bound)
DIST_SELL_X_DIFF = 1e-5
MESH3D_SPEC = f"mesh3d:{NX * NX}"
# the checkpointed distributed mixed CGSR solve: saved every
# DIST_CKPT_EVERY restarts, aborted at DIST_CKPT_CUT, resumed to the
# reference's 26/780; its x equal to the uninterrupted distributed solve's
# bit for bit (the resumed cycles are the same operations on the same bits).
# df64, cut short: aborted at DIST_CKPT_DF64[0], resumed to
# DIST_CKPT_DF64[1], equal to a solve cut at DIST_CKPT_DF64[1]
DIST_CKPT_EVERY = 4
DIST_CKPT_CUT = 12
DIST_CKPT_DF64 = (4, 8)
# the distributed bf16 tier at convdiff(512), cut at this many restarts (it
# has no escalation; the single card's bf16 solve stalls later, PERF.md)
DIST_BF16_RESTARTS = 6
# the dtype forms each rank must launch over the tiers: (bf16, fp32) under
# mixed-cb, (fp32, fp64) under baseline-cb, (bf16, bf16) under the bf16 tier
# (K2x2 takes no bf16 vector: ICWY passes it fp32), K4's pair mode under df64
DIST_FORMS = {
    "basis_gram": ("bf16_f32", "f32_f64", "bf16_bf16"),
    "basis_update_gram": ("bf16_f32", "f32_f64", "bf16_bf16"),
    "basis_update_sumsq": ("bf16_f32", "f32_f64", "bf16_bf16"),
    "basis_gram2": ("bf16_f32", "f32_f64"),
    "basis_axpy": ("bf16_f32_f64", "f32_f64_f64", "bf16_bf16_f64", "pair")}
# the distributed bf16 cycles above the bf16 floor (backward error above
# 10 * CB_BF16_BEST) are held this close to the single card's, cycle by
# cycle (the H100 read them within 8%); at the floor (~1e-6) the cycles
# scatter (2.1e-7..2.0e-6 over the single card's last four of the Jacobi
# solve at 262K, whose best the distributed one read 3.8x above): the two
# bests are held within DIST_BF16_FLOOR
DIST_BF16_CYCLE = 1.25
DIST_BF16_FLOOR = 5.0
# the distributed mixed-cb CGSR solve against the single card's: each
# cycle's backward error within DIST_CB_CYCLE, and x within DIST_CB_X_DIFF
# relative (the H100 read 4.8e-3: a bf16 basis summed per rank rounds
# apart, and convdiff@1M's x moves far for a small residual change)
DIST_CB_CYCLE = 1.5
DIST_CB_X_DIFF = 1e-2
DIST_TIMEOUT = 600     # seconds for the spawned ranks, and for each collective
# the cli phase: the reference-format entry points at convdiff@1M.  The
# solve command line's summary block as the reference's sweep runner scrapes
# it (automated.py:33-38; tests/test_cli.py:SUMMARY_REGEX)
SUMMARY_REGEX = (
    r"Found solution with rel prec res norm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*) when k = "
    r"(\d+) and i = (\d+)\n  total iterations = (\d+)\n  ilu took "
    r"(\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)s; gmres took (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)s\n"
    r"  resNorm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*); errNorm = (\d\.?\d*e(?:\+|-)\d+|\d+\.?\d*)\n")
CLI_HISTORY = (26, 780)   # the reference's convdiff@1M history, CGSR, identity
# the cli phase's solve runs: (label, flags beyond --Apath, --rlen 30,
# --tol 1e-8, --json; the kernels the run must launch; K1's dtype form).
# CGSR launches K2, K3 GRAM and SUMSQ; the defaults (sequential MGS, exact
# ILU) K7 and K6 fused; every run K1 in its inner dtype, K1's residual mode
# and K4
CLI_SOLVES = (
    ("mixed cgsr", ["--mode", "mixed", "--orth", "cgsr", "--prec", "identity"],
     ("dia_spmv", "dia_residual", "basis_gram", "basis_update_gram", "basis_update_sumsq",
      "basis_axpy"), "f32"),
    ("baseline cgsr --bpath", ["--mode", "baseline", "--orth", "cgsr", "--prec", "identity",
                               "--bpath", None],
     ("dia_spmv", "dia_residual", "basis_gram", "basis_update_gram", "basis_update_sumsq",
      "basis_axpy"), "f64"),
    ("defaults (mgs, ilu) mixed", [],
     ("dia_spmv", "dia_residual", "basis_mgs", "ilu_trisolve_fused", "basis_axpy"), "f32"))
# the --dist command line on the distributed path's ranks: the flags of the
# cli phase's "mixed cgsr" run (CLI_SOLVES), whose block it is held to
CLI_DIST_ARGV = ["--rlen", "30", "--tol", "1e-8", "--json", "--mode", "mixed", "--orth",
                 "cgsr", "--prec", "identity"]
# condest as the TPU campaign ran it (scripts/round5_hw_campaign.sh:113-116):
# (spec, --max-iters, the TPU's printed sigma_max, sigma_min and t;
# results/round5/condest_convdiff.txt and condest_mesh3d.txt).  convdiff:1024
# is make_synth's beta = 20; the TPU reached its cap there (t = 20001)
CONDEST_RUNS = (("convdiff:1024", 20000, 8.03743, 9.3754e-05, 20001),
                ("mesh3d:262144", 20000, 30.9516, 7.76345, 25))
CONDEST_SIGMA_MAX_REL = 1e-5   # sigma_max against the TPU's, relative
CONDEST_T_SLACK = 1            # mesh3d's t against the TPU's 25
# mesh3d:262144's cond is held to an extended-precision estimate, not to the
# TPU's 3.98683: ``python scripts/port_condest_cpu.py --n 262144 --routes
# jax,extended`` gives 4.004401852575535 on its numpy route, whose LSQR loop
# runs in np.longdouble, and 4.003861567590559 on the JAX package's fp64 CSR
# route.  The Golub-Kahan recurrence amplifies rounding, and sigma_min is set
# at step 14 of 24 there, so fp64 routes that sum in other orders land
# 1.35e-4 apart and the TPU's double-float SELL 4.4e-3 off (PERF.md section 6)
CONDEST_MESH3D_EXTENDED = 4.004401852575535
CONDEST_MESH3D_JAX_FP64 = 4.003861567590559
CONDEST_COND_REL = 1e-4
# the batched phase: solve_batched at convdiff@1M, as the TPU campaign's
# scripts/bench_batched.py set it up (x_true_j = rand_vect(n, 40 + j), b_j =
# A x_true_j; CGSR, Jacobi, restart 30, tol 1e-8): (mode, lanes) per solve.
# The TPU's 6,240 iterations over 8 lanes (results/round4/bench_batched.txt)
# are 780 a lane: each lane is held within one restart of 26/780
BATCHED_SOLVES = (("mixed", 8), ("baseline", 8))
BATCHED_SEED = 40
BATCHED_HISTORY = (26, 780)
BATCHED_WALL_REPS = 1             # timed batched and sequential runs, after a warm-up
BATCHED_TRACE_RESTARTS = 1        # cycles of the traced s = 8 mixed solve
# what a batched solve (CGSR, Jacobi, DIA) launches, and what it must not
BATCHED_KERNELS = ("dia_spmv", "dia_residual", "basis_gram", "basis_update_gram",
                   "basis_update_sumsq", "basis_axpy")
# bench_kernels' time of a kernel is held within this factor of the spread
# of BENCH_REPEATS readings of its own timer (cli/bench_kernels._timed: a loop
# of BENCH_TRIALS back-to-back calls cycling through copies of the operands)
# on this script's operands of the same shapes
BENCH_AGREE = (0.9, 1.1)
BENCH_REPEATS = 5
BENCH_TRIALS = 20

def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def device_lines():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return smi


def nvcc_version():
    from gmres_tpu_torch.ops.cuda._build import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[-1] if out else "?"


class Timer:
    """Median device time of a callable, one CUDA-event pair per launch,
    with the 50 MB L2 flushed before each launch (the main path streams the
    basis through L2 between two calls of any kernel).  The card spins
    GUARD_CYCLES after the flush, so that the host has enqueued the timed
    call before its start event fires: the events then hold the device's
    time and no host enqueue gap (without it a wrapper's Python work lands
    inside the events whenever the flush ends first)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps=REPS):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(GUARD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        self.last = times
        return statistics.median(times)


def copy_bandwidth(torch):
    nbytes = 256 * 1024 * 1024
    src = torch.ones(nbytes // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = Timer(torch)(lambda: dst.copy_(src))
    return ms, 2 * nbytes / (ms * 1e-3) / 1e9


def compare_each(dtype, got, want, scale):
    """As compare, each output held to its own scale; reports the output
    nearest its tolerance."""
    worst = None
    for g, w_, sc in zip(got, want, scale):
        err, bound, ok = compare(dtype, [g], [w_], [sc])
        if worst is None or err / max(bound, 1e-300) > worst[0] / max(worst[1], 1e-300):
            worst = (err, bound, ok)
        if not ok:
            worst = (err, bound, False)
            break
    return worst


def compare(dtype, got, want, scale):
    """Max abs error of `got` against `want`, and whether it is within the
    tolerance relative to `scale`."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    bound = max(TOL_REL[dtype] * float(s.abs().max()) for s in scale)
    ok = err <= bound
    return err, bound, ok


class Records:
    """Per-kernel, per-dtype error, timing and bound records for the JSON
    line.  A kernel's bound is the larger of its bytes over the copy
    yardstick, its operations over the card's peak for their type and (K6)
    its barriers times one empty barrier of the same sync; it is bound by
    bytes when the bytes term is the largest, else by operations
    (arithmetic or barriers)."""

    def __init__(self, copy_gbs):
        self.copy_gbs = copy_gbs
        self.records = {}
        self.failures = []

    def __call__(self, kname, dtype, err, bound, ok, ms, plain_ms, nbytes, flops=0,
                 library_ms=None, barrier_ms=0.0, key=None):
        gbs = nbytes / (ms * 1e-3) / 1e9
        bytes_ms = nbytes / (self.copy_gbs * 1e9) * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        bound_ms = max(bytes_ms, ops_ms, barrier_ms)
        bound_by = "bytes" if bound_ms == bytes_ms else "operations"
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"kernel {kname:<22} {key or dtype:<8} max_abs_err={err:.3e} (tol {bound:.3e}) "
            f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms ({gbs:.1f} GB/s, "
            f"{gbs / self.copy_gbs:.2f} of copy)  bound {bound_ms:.4f} ms [{bound_by}: bytes "
            f"{bytes_ms:.4f}, flops {ops_ms:.4f}, barriers {barrier_ms:.4f}]  "
            f"plain {plain_ms:.4f} ms  one call {lib}")
        if not ok:
            self.failures.append(f"{kname} {dtype}")
        self.records.setdefault(kname, {})[key or dtype] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, gb_per_s=gbs, bound_ms=bound_ms,
            bound_by=bound_by, bytes_ms=bytes_ms, flops_ms=ops_ms, barrier_ms=barrier_ms,
            library_ms=library_ms)

    def require_ok(self):
        require(not self.failures,
                f"kernels disagree with their plain versions: {self.failures}")


def barrier_ms(torch, timer, blocks):
    """Device time of one empty grid.sync() of a cooperative grid of
    `blocks` blocks (SYNC_PROBE barriers in one launch)."""
    from gmres_tpu_torch.ops.cuda.mgs_kernel import grid_sync_probe

    return timer(lambda: grid_sync_probe(blocks, SYNC_PROBE), 5) / SYNC_PROBE


def csr_tensor(torch, A_csr, dt):
    """The operator as a torch.sparse_csr_tensor on the card (for the
    one-call time of an SpMV; the port never calls it)."""
    rp, ci, v = A_csr.numpy_arrays()
    return torch.sparse_csr_tensor(torch.tensor(rp.astype(np.int32), device="cuda"),
                                   torch.tensor(ci.astype(np.int32), device="cuda"),
                                   torch.tensor(v, dtype=dt, device="cuda"),
                                   size=(A_csr.n_rows, A_csr.n_cols))


def check_residual(torch, record, kname, dt, dt_name, timer, fn_cuda, fn_plain, scale_r,
                   nbytes, flops, key=None):
    """A residual mode (fp64 operator, norm of r demoted to dt) against its
    plain version: r within the fp64 tolerance of |b| + |A||x|, the sums of
    squares (fp64 accumulation against the plain version's accumulation in
    the inner dtype) within 1e-5 (fp32) or 1e-12 (fp64) relative."""
    got, want = fn_cuda(), fn_plain()
    err_r, bound_r, ok_r = compare("float64", got[:1], want[:1], [scale_r])
    ss_err = max(abs(float(g - w_)) / float(w_) for g, w_ in zip(got[1:], want[1:]))
    ss_tol = 1e-5 if dt == torch.float32 else 1e-12
    log(f"  {kname}[{key or dt_name} norm] sums of squares rel err {ss_err:.3e} "
        f"(tol {ss_tol:.0e})")
    record(kname, dt_name, err_r, bound_r, ok_r and ss_err <= ss_tol,
           timer(fn_cuda), timer(fn_plain), nbytes, flops, key=key)


def device_kernels(torch, fn, sessions=5):
    """Names of the device kernels one call of fn launches (torch.profiler):
    the most that any of `sessions` profiled calls recorded.  A session can
    drop device kernels but not invent them: on the card one has recorded
    none (the first session of a fresh process) and one only the second of
    K3 GRAM fp64's two kernels.  A session that records none in all fails
    the run.  Late in a long process the card's profiler has recorded no
    device activity at all, for any kernel, so the counts are taken before
    the solves (one_kernel_checks); early in one (K2x2 fp64, PR 16) three
    sessions in a row recorded none, so it takes five."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) > len(best):
            best = names
    require(best, f"torch.profiler recorded no device kernel in {sessions} sessions")
    return best


def gram_grid_table(torch, timer, V, w, ref, dt_name, copy_gbs):
    """K2 at the 31-row basis on grids of GRAM_GRID_BLOCKS_PER_SM blocks per
    SM: bits equal to `ref`, time and share of copy; and the device kernels
    one wrapper call launches (one)."""
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_

    rows, n = V.shape
    nbytes = (rows + 1) * n * V.element_size()
    for per_sm in GRAM_GRID_BLOCKS_PER_SM:
        out = ok_.gram_cuda(V, w, rows, per_sm)
        grid = ok_.gram_cuda.grid
        require(torch.equal(out, ref), f"K2 {dt_name}: the same bits on {grid} blocks")
        ms = timer(lambda: ok_.gram_cuda(V, w, rows, per_sm))
        log(f"  K2 {dt_name} blocks/SM {per_sm}: {grid} blocks, {ms:.4f} ms, "
            f"{nbytes / (ms * 1e-3) / 1e9 / copy_gbs:.3f} of copy; bits equal")
    names = device_kernels(torch, lambda: ok_.gram_cuda(V, w, rows))
    log(f"  K2 {dt_name} device kernels a call: {len(names)} {names}")
    require(len(names) == 1, f"K2 {dt_name}: one launch a call ({names})")


def update_gram_grid_table(torch, timer, V, w, u, ref, dt_name, copy_gbs):
    """K3 GRAM at the 31-row basis: in fp32 (one launch) on grids of
    UG_GRID_BLOCKS_PER_SM blocks per SM, and the device kernels one wrapper
    call launches (one); in fp64 (block partials added by torch.sum) under
    UG_F64_PADS bytes of dynamic shared memory that cap its blocks an SM.
    Each: bits equal to `ref`, time and share of copy; w' equal to K3
    SUMSQ's (the one-row-at-a-time form's bits)."""
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_

    rows, n = V.shape
    nbytes = (rows + 2) * n * V.element_size()
    if V.dtype == torch.float32:
        plan = ok_.update_gram_plan(n, rows, V.element_size(), 1)
        log(f"  K3 GRAM {dt_name} plan: tiles of {plan.tile} columns, {plan.n_tiles} tiles, "
            f"{plan.shared_bytes} B staged a block, {plan.blocks_per_sm} blocks an SM")
        settings = [(f"blocks/SM {p or 'plan'}", p, None) for p in UG_GRID_BLOCKS_PER_SM]
    else:
        settings = [(f"pad {pad} B", None, pad) for pad in UG_F64_PADS]
    default_pad = ok_.UG_F64_PAD
    for label, per_sm, pad in settings:
        if pad is not None:
            ok_.UG_F64_PAD = pad
        try:
            out = ok_.update_gram_cuda(V, w, u, rows, per_sm)
            grid = ok_.update_gram_cuda.grid
            require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                    f"K3 GRAM {dt_name}: the same bits on {grid} blocks, {label}")
            ms = timer(lambda: ok_.update_gram_cuda(V, w, u, rows, per_sm))
        finally:
            ok_.UG_F64_PAD = default_pad
        log(f"  K3 GRAM {dt_name} {label}: {grid} blocks, {ms:.4f} ms, "
            f"{nbytes / (ms * 1e-3) / 1e9 / copy_gbs:.3f} of copy; bits equal")
    require(torch.equal(ref[0], ok_.update_sumsq_cuda(V, w, u, rows)[0]),
            f"K3 GRAM {dt_name}: w' equal to K3 SUMSQ's")
    names = device_kernels(torch, lambda: ok_.update_gram_cuda(V, w, u, rows))
    log(f"  K3 GRAM {dt_name} device kernels a call: {len(names)} {names}")
    want = 1 if V.dtype == torch.float32 else 2
    require(len(names) == want, f"K3 GRAM {dt_name}: {want} device kernels a call ({names})")


def df_update_gram_table(torch, timer, Vh, Vl, wh, wl, u, rows, ref, copy_gbs):
    """K10 at the pair basis over tiles DF_UG_TILES and grids of
    DF_UG_BLOCKS_PER_SM blocks an SM: w' equal to `ref`'s at every setting,
    u2 equal to `ref`'s at every grid of the plan's tile (its summation
    follows the tile), time and share of copy.  Its device kernels a call
    are counted by one_kernel_checks."""
    from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk

    n = Vh.shape[1]
    nbytes = (2 * rows + 4) * 4 * n
    plan = dk.df_update_gram_plan(n, rows, 1)
    log(f"  K10 rows {rows} plan: tiles of {plan.tile} columns, {plan.n_tiles} tiles, "
        f"{plan.shared_bytes} B staged a block, {plan.blocks_per_sm} blocks an SM")
    for tile in DF_UG_TILES:
        for per_sm in DF_UG_BLOCKS_PER_SM:
            out = dk.df_update_gram_cuda(Vh, Vl, wh, wl, u, rows, per_sm, tile)
            grid = dk.df_update_gram_cuda.grid
            w_equal = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
            u2_equal = torch.equal(out[2], ref[2])
            require(w_equal, f"K10 rows {rows}: w' equal at tile {tile}, {grid} blocks")
            require(u2_equal or tile not in (None, plan.tile),
                    f"K10 rows {rows}: the same u2 bits on {grid} blocks of the plan's tile")
            ms = timer(lambda: dk.df_update_gram_cuda(Vh, Vl, wh, wl, u, rows, per_sm, tile))
            log(f"  K10 rows {rows} tile {tile or plan.tile} blocks/SM {per_sm}: {grid} blocks, "
                f"{ms:.4f} ms, {nbytes / (ms * 1e-3) / 1e9 / copy_gbs:.3f} of copy; w' bits "
                f"equal, u2 bits {'equal' if u2_equal else 'differ'}")


def halo_table(torch, timer, dt, data, offs, x, left, right, A262, copy_gbs):
    """Beside K12's interior block (r rows, D bands): a torch device copy
    of K12's bytes, an empty kernel (the timer's floor) and K1 on A262 (the
    same row count, offsets +-1 and +-NX_262K), all under one timer."""
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk

    D, r = data.shape
    sz = dt.itemsize
    nbytes = (D + 2) * r * sz + (left.shape[0] + right.shape[0]) * sz
    ms = timer(lambda: hk.dia_spmv_halo_cuda(data, offs, x, left, right))
    log(f"  K12 {dt} interior: {ms:.4f} ms, {nbytes / (ms * 1e-3) / 1e9 / copy_gbs:.3f} of copy")
    src = torch.ones(nbytes // 2 // sz, dtype=dt, device="cuda")
    dst = torch.empty_like(src)
    ms = timer(lambda: dst.copy_(src))
    log(f"  torch device copy of K12's {2 * src.numel() * sz} bytes ({dt}): {ms:.4f} ms, "
        f"{2 * src.numel() * sz / (ms * 1e-3) / 1e9 / copy_gbs:.3f} of copy")
    ms = timer(lambda: torch.cuda._sleep(0))
    log(f"  an empty kernel (torch.cuda._sleep(0)) under the same timer: {ms:.4f} ms")
    d262 = A262.data.to("cuda", dt)
    x262 = torch.tensor(np.random.default_rng(11).random(A262.n_rows), dtype=dt, device="cuda")
    ms = timer(lambda: sk.dia_spmv_cuda(d262, A262.offsets, x262))
    log(f"  K1 at n = {A262.n_rows:,} (offsets {A262.offsets}, {dt}): {ms:.4f} ms, "
        f"{(len(A262.offsets) + 2) * A262.n_rows * sz / (ms * 1e-3) / 1e9 / copy_gbs:.3f} "
        f"of copy")


def k1_grids(torch, data, offs, x, y, d64, x64, b64, dt, dt_name):
    """K1 on grids of K1_GRIDS_PER_SM blocks an SM (and one block, and the
    default of one a block of rows): y, and in residual mode (fp64 operator,
    the norm in dt) r and both sums, the same bits on each."""
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = sk.dia_residual_cuda(d64, offs, b64, x64, dt)
    grids = (1, *(sms * k for k in K1_GRIDS_PER_SM))
    for grid in grids:
        require(torch.equal(sk.dia_spmv_cuda(data, offs, x, grid=grid), y),
                f"K1 {dt_name}: y the same bits on {grid} blocks")
        got = sk.dia_residual_cuda(d64, offs, b64, x64, dt, grid=grid)
        require(all(torch.equal(g, w_) for g, w_ in zip(got, res)),
                f"K1 residual {dt_name} norm: r and both sums the same bits on {grid} blocks")
    log(f"  K1 {dt_name}: y, and r with ||r'||^2 = {float(res[1])!r}, ||x||^2 = "
        f"{float(res[2])!r}, the same bits on grids of {grids} blocks and the default")


def check_kernels(torch, A_csr, record):
    """K1-K4 against their plain versions at the banded path's shapes, with
    the one PyTorch call that computes the same function where there is
    one (a CSR torch.mv for K1, torch.mv for K2, addmv for K4 into fp64)."""
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_, outer_kernel as ou, spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import from_csr

    dia = from_csr(A_csr)
    require(dia is not None and len(dia.offsets) == 5, "convdiff repacks to 5 DIA bands")
    n = dia.n_rows
    m1 = RLEN + 1
    rng = np.random.default_rng(0)
    timer = Timer(torch)

    x_np = rng.random(n)
    b_np = rng.standard_normal(n)
    V_np = rng.standard_normal((m1, n)) / np.sqrt(n)
    w_np = rng.standard_normal(n)
    u_np = rng.standard_normal(m1)

    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        s = dt.itemsize
        data = dia.data.to("cuda", dt)
        offs = dia.offsets
        D = len(offs)
        x = torch.tensor(x_np, dtype=dt, device="cuda")
        V = torch.tensor(V_np, dtype=dt, device="cuda")
        w = torch.tensor(w_np, dtype=dt, device="cuda")
        u = torch.tensor(u_np, dtype=dt, device="cuda")

        # K1 plain mode
        got = sk.dia_spmv_cuda(data, offs, x)
        want = sk.dia_spmv_plain(data, offs, x)
        scale = sk.dia_spmv_plain(data.abs(), offs, x.abs())
        Acsr = csr_tensor(torch, A_csr, dt)
        record("dia_spmv", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: sk.dia_spmv_cuda(data, offs, x)),
               timer(lambda: sk.dia_spmv_plain(data, offs, x)), (D + 2) * n * s,
               2 * D * n, timer(lambda: torch.mv(Acsr, x)))
        del Acsr

        # K1 residual mode: outer dtype fp64; the norm of r demoted to the
        # inner dtype dt (mixed: fp32, baseline: fp64)
        d64 = dia.data.to("cuda", torch.float64)
        x64 = torch.tensor(x_np, dtype=torch.float64, device="cuda")
        b64 = torch.tensor(b_np, dtype=torch.float64, device="cuda")
        check_residual(torch, record, "dia_residual", dt, dt_name, timer,
                       lambda: sk.dia_residual_cuda(d64, offs, b64, x64, dt),
                       lambda: sk.dia_residual_plain(d64, offs, b64, x64, dt),
                       b64.abs() + sk.dia_spmv_plain(d64.abs(), offs, x64), (D + 3) * n * 8,
                       (2 * D + 5) * n)
        k1_grids(torch, data, offs, x, sk.dia_spmv_cuda(data, offs, x), d64, x64, b64, dt,
                 dt_name)

        # K2 gram over all m+1 rows (the last Arnoldi step)
        got = ok_.gram_cuda(V, w, m1)
        want = ok_.gram_plain(V, w, m1)
        scale = ok_.gram_plain(V.abs(), w.abs(), m1)
        record("basis_gram", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: ok_.gram_cuda(V, w, m1)),
               timer(lambda: ok_.gram_plain(V, w, m1)), (m1 + 1) * n * s, 2 * m1 * n,
               timer(lambda: torch.mv(V[:m1], w)))
        gram_grid_table(torch, timer, V, w, got, dt_name, record.copy_gbs)

        # K3 update + gram
        got = ok_.update_gram_cuda(V, w, u, m1)
        want = ok_.update_gram_plain(V, w, u, m1)
        sw = w.abs() + torch.mv(V.abs().t(), u.abs())
        scale = [sw, ok_.gram_plain(V.abs(), sw, m1)]
        record("basis_update_gram", dt_name,
               *compare(dt_name, got, want, scale),
               timer(lambda: ok_.update_gram_cuda(V, w, u, m1)),
               timer(lambda: ok_.update_gram_plain(V, w, u, m1)), (m1 + 2) * n * s,
               4 * m1 * n)
        update_gram_grid_table(torch, timer, V, w, u, got, dt_name, record.copy_gbs)

        # K3 update + sum of squares
        got = ok_.update_sumsq_cuda(V, w, u, m1)
        want = ok_.update_sumsq_plain(V, w, u, m1)
        scale = [sw, torch.dot(sw, sw)]
        record("basis_update_sumsq", dt_name,
               *compare(dt_name, got, want, scale),
               timer(lambda: ok_.update_sumsq_cuda(V, w, u, m1)),
               timer(lambda: ok_.update_sumsq_plain(V, w, u, m1)), (m1 + 2) * n * s,
               (2 * m1 + 2) * n)

        # K4: x (fp64) += y^T V[:m]; one call computes it only on an fp64 basis
        y = u[:RLEN].contiguous()
        got = ou.basis_axpy_cuda(x64.clone(), V, y)
        want = ou.basis_axpy_plain(x64.clone(), V, y)
        scale = ou.basis_axpy_plain(x64.abs(), V.abs(), y.abs())
        xk, xp, xl = x64.clone(), x64.clone(), x64.clone()
        one_call = (timer(lambda: xl.addmv_(V[:RLEN].t(), y)) if dt == torch.float64
                    else None)
        record("basis_axpy", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: ou.basis_axpy_cuda(xk, V, y)),
               timer(lambda: ou.basis_axpy_plain(xp, V, y)), RLEN * n * s + 2 * n * 8,
               2 * RLEN * n + n, one_call)
        torch.cuda.synchronize()
        del data, x, V, w, u, d64, x64, b64
    record.require_ok()


def check_sell_kernels(torch, S, A_csr, record):
    """K5 in plain mode (fp32, fp64; one call: a CSR torch.mv) and residual
    mode (fp64 operator, fp32 and fp64 norm) against its plain versions on
    the staged operator."""
    from gmres_tpu_torch.ops.cuda import sell_kernel as sl

    n, n_slots = S.n_rows, S.n_slots
    rng = np.random.default_rng(1)
    timer = Timer(torch)
    x_np = rng.random(n)
    b64 = torch.tensor(rng.standard_normal(n), dtype=torch.float64, device="cuda")
    x64 = torch.tensor(x_np, dtype=torch.float64, device="cuda")
    v64, cols, sp = S.vals, S.cols, S.slice_ptr
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        s = dt.itemsize
        vals = v64.to(dt)
        x = x64.to(dt)
        got = sl.sell_spmv_cuda(vals, cols, sp, x, n)
        want = sl.sell_spmv_plain(vals, cols, sp, x, n)
        scale = sl.sell_spmv_plain(vals.abs(), cols, sp, x.abs(), n)
        Acsr = csr_tensor(torch, A_csr, dt)
        # bytes: each slot's value and int32 column, x once, y
        record("sell_spmv", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: sl.sell_spmv_cuda(vals, cols, sp, x, n)),
               timer(lambda: sl.sell_spmv_plain(vals, cols, sp, x, n)),
               n_slots * (s + 4) + 2 * n * s, 2 * n_slots, timer(lambda: torch.mv(Acsr, x)))
        del Acsr
        check_residual(torch, record, "sell_residual", dt, dt_name, timer,
                       lambda: sl.sell_residual_cuda(v64, cols, sp, b64, x64, dt),
                       lambda: sl.sell_residual_plain(v64, cols, sp, b64, x64, dt),
                       b64.abs() + sl.sell_spmv_plain(v64.abs(), cols, sp, x64, n),
                       n_slots * 12 + 3 * n * 8, 2 * n_slots + 5 * n)
        torch.cuda.synchronize()
        del vals, x, got, want, scale
    record.require_ok()


def csr_residual(A_csr, x, b):
    """b - A x in fp64 numpy, independent of the port's kernels."""
    rp, ci, v = A_csr.numpy_arrays()
    rows = np.repeat(np.arange(A_csr.n_rows), np.diff(rp))
    return b - np.bincount(rows, weights=v * x[ci], minlength=A_csr.n_rows)


def walls_text(v):
    """Walls as logged: the one wall, or the median of several with their
    range."""
    if len(v) == 1:
        return f"{v[0]:.4f}"
    return f"median {statistics.median(v):.4f} min {min(v):.4f} max {max(v):.4f}"


def solve_timed(torch, label, mode, A_csr, A_dev, cfg, timed, M=None, history=False,
                converges=True, warm_up=True):
    """One warm-up (unless not `warm_up`) and `timed` timed solves of A x = b
    (x_true = rand_vect(n, 42)) on the staged operator; hold the last to a
    finite x of shape (n,) and, if it `converges`, to convergence and a
    backward error <= 1e-8 recomputed here in fp64.  Returns (result, with
    that backward error as `backward_error`, median wall)."""
    from gmres_tpu_torch import rand_vect, solve

    n = A_csr.n_rows
    x_true = rand_vect(n, 42)
    b = -csr_residual(A_csr, x_true, np.zeros(n))
    b_dev = torch.tensor(b, device="cuda")
    if warm_up:
        solve(A_dev, b_dev, cfg, M=M)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        res = solve(A_dev, b_dev, cfg, M=M, record_history=history)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    x = res.x.cpu().numpy()
    a_fro = float(np.linalg.norm(A_csr.vals.numpy()))
    backward = float(np.linalg.norm(csr_residual(A_csr, x, b))
                     / (np.linalg.norm(b) + a_fro * np.linalg.norm(x)))
    res.backward_error = backward
    err = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    wall = statistics.median(times)
    log(f"solve {label} {mode}: converged={res.converged} restarts={res.restarts} "
        f"total_iters={res.total_iters} wall {walls_text(times)} s "
        f"{'after a warm-up ' if warm_up else ''}backward_err={backward:.3e} "
        f"rel_fwd_err={err:.3e}")
    if history:
        log(f"  history {label} {mode} (backward error per cycle): "
            + ", ".join(f"{h['rel_initial']:.3e}" if "rel_initial" in h else "escalated:"
                        for h in res.history))
    if converges:
        require(res.converged, f"{label} {mode} converged")
        require(backward <= 1e-8, f"{label} {mode} backward error {backward:.3e} <= 1e-8")
    require(np.all(np.isfinite(x)) and x.shape == (n,), f"{label} {mode} x finite, shape ({n},)")
    return res, wall


def solve_with_plain(torch, A_csr, A_dev, cfg, M, *kernels):
    """One solve as solve_timed's (history recorded) with the wrappers of
    `kernels` ("gram": K2, "update_gram": K3 GRAM, "update_sumsq": K3
    SUMSQ) swapped for their plain versions (torch.mv on the card): the
    history that the kernels' own rounding is held to, with its backward
    error as `backward_error`."""
    from gmres_tpu_torch import rand_vect, solve
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_

    b = -csr_residual(A_csr, rand_vect(A_csr.n_rows, 42), np.zeros(A_csr.n_rows))
    saved = {k: getattr(ok_, f"{k}_cuda") for k in kernels}
    for k in kernels:
        setattr(ok_, f"{k}_cuda", getattr(ok_, f"{k}_plain"))
    try:
        res = solve(A_dev, torch.tensor(b, device="cuda"), cfg, M=M, record_history=True)
    finally:
        for k, wrapper in saved.items():
            setattr(ok_, f"{k}_cuda", wrapper)
    x = res.x.cpu().numpy()
    res.backward_error = float(np.linalg.norm(csr_residual(A_csr, x, b))
                               / (np.linalg.norm(b)
                                  + np.linalg.norm(A_csr.vals.numpy()) * np.linalg.norm(x)))
    return res


def config(mode, precond, orth="cgsr", **kw):
    from gmres_tpu_torch import GmresConfig, PrecisionSpec

    kw.setdefault("max_restarts", MAX_RESTARTS)
    return GmresConfig(precision=PrecisionSpec.from_mode(mode), orth=orth, precond=precond,
                       restart_length=RLEN, tol=TOL, **kw)


def run_main_path(torch, label, A_csr, A_dev, expect):
    """Solve the path's problem in both modes on the staged operator, with no
    preconditioner; hold each mode to its expected history
    (`expect(restarts, iters)` returns the failure text or None); return
    the launch counts of the path's solves, and x and the median wall of
    each mode."""
    from gmres_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    other = {k for path, ks in PATH_KERNELS.items() if path != label for k in ks}
    other |= set(ILU_KERNELS) | set(MGS_KERNELS) | set(DF64_KERNELS) | set(DIST_KERNELS)
    walls, xs = {}, {}
    reset_launch_counts()
    for mode in ("baseline", "mixed"):
        before = launch_counts()
        res, walls[mode] = solve_timed(torch, label, mode, A_csr, A_dev,
                                       config(mode, "identity"), 3)
        xs[mode] = res.x.cpu().numpy()
        after = launch_counts()
        counts = {k: after[k] - before[k] for k in after}
        log(f"  launches {label} {mode}: {counts}")
        bad = expect(res.restarts, res.total_iters)
        require(bad is None, f"{label} {mode}: {bad}")
        require(all(v > 0 for k, v in counts.items() if k not in other),
                f"{label} {mode}: every kernel of the path launched ({counts})")
        require(all(counts[k] == 0 for k in other),
                f"{label} {mode}: no other path's SpMV kernel, K6 nor MGS kernel launched "
                f"({counts})")
    log(f"{label} mixed/baseline wall ratio: {walls['mixed'] / walls['baseline']:.4f} "
        f"(baseline/mixed speedup {walls['baseline'] / walls['mixed']:.4f})")
    return launch_counts(), xs, walls


def stage_timed(torch, A_csr):
    from gmres_tpu_torch import stage

    t0 = time.perf_counter()
    A_dev = stage(A_csr)
    torch.cuda.synchronize()
    return A_dev, time.perf_counter() - t0


def one_kernel_checks(torch, n):
    """K2x2 (fp32 and fp64, 31 rows at n: K2's kernel with two vectors), K10
    (rows 31 and 16 of the pair basis at n) and K12's residual mode
    (convdiff@1M's shard: r = n / DIST_RANKS, offsets +-1 and +-NX, edges of
    NX values, zero on the first and last shard) are each one device kernel
    a call.  Counted before the solves, with the K2 and K3 GRAM counts."""
    from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_

    for dt in (torch.float32, torch.float64):
        V, w, _ = mgs_basis(torch, n, dt, 3)
        names = device_kernels(torch, lambda: ok_.gram2_cuda(V, w, V[RLEN], RLEN + 1))
        log(f"  K2x2 {dt} device kernels a call: {len(names)} {names}")
        require(len(names) == 1 and kernel_group(names[0]) == "K2x2",
                f"K2x2 {dt}: one device kernel a call, K2's kernel with two vectors ({names})")
        del V, w

    Vh, Vl, wh, wl, u, _, _ = df64_pair_basis(torch, n, 7)
    for rows in (RLEN + 1, MID_ROWS):
        ur = u.clone()
        ur[rows:] = 0
        names = device_kernels(torch, lambda: dk.df_update_gram_cuda(Vh, Vl, wh, wl, ur, rows))
        log(f"  K10 rows {rows} device kernels a call: {len(names)} {names}")
        require(len(names) == 1, f"K10 rows {rows}: one device kernel a call ({names})")
    del Vh, Vl, wh, wl, u
    r, offs = n // DIST_RANKS, (-NX, -1, 0, 1, NX)
    rng = np.random.default_rng(12)
    data, x, b = (torch.tensor(rng.standard_normal(shape), device="cuda")
                  for shape in ((len(offs), r), r, r))
    edge = torch.tensor(rng.random(NX), device="cuda")
    zero = torch.zeros_like(edge)
    for side, left, right in (("interior", edge, edge), ("first", zero, edge),
                              ("last", edge, zero)):
        names = device_kernels(torch, lambda: hk.dia_residual_halo_cuda(
            data, offs, b, x, left, right, torch.float32))
        log(f"  K12 residual {side} device kernels a call: {len(names)} {names}")
        require(len(names) == 1, f"K12 residual {side}: one device kernel a call ({names})")
    torch.cuda.synchronize()


def convdiff_path(torch, record, A):
    from gmres_tpu_torch.ops.dia import DIAMatrix

    check_kernels(torch, A, record)
    one_kernel_checks(torch, A.n_rows)
    A_dev, secs = stage_timed(torch, A)
    require(isinstance(A_dev, DIAMatrix), f"convdiff stages as DIA, got {type(A_dev).__name__}")
    log(f"stage: {type(A_dev).__name__} offsets={A_dev.offsets} on {A_dev.device} "
        f"in {secs:.3f} s")

    def expect(restarts, iters):
        log(f"  convdiff history vs TPU reference {TPU_ITERS}: diff {iters - TPU_ITERS:+d}")
        if abs(iters - TPU_ITERS) > RLEN:
            return f"total_iters {iters} not within {RLEN} of {TPU_ITERS}"
        return None

    return (*run_main_path(torch, "convdiff", A, A_dev, expect), A_dev)


def mesh3d_path(torch, record):
    """The unstructured path; returns its launch counts, the matrix and its
    staged SELL operator for the compressed-basis path, and the mixed
    solve's x (the distributed SELL route is held to it)."""
    from gmres_tpu_torch.io.synth import unstructured_mesh
    from gmres_tpu_torch.ops.sell import SELLMatrix

    t0 = time.perf_counter()
    A = unstructured_mesh(NX * NX, run=8)
    log(f"matrix: unstructured_mesh({NX * NX}, run=8) n={A.n_rows:,} nnz={A.nnz:,} "
        f"built in {time.perf_counter() - t0:.2f} s")
    A_dev, secs = stage_timed(torch, A)
    require(isinstance(A_dev, SELLMatrix), f"mesh3d stages as SELL, got {type(A_dev).__name__}")
    widths = (torch.diff(A_dev.slice_ptr) // 32).cpu().numpy()
    log(f"stage: {type(A_dev).__name__} (pack + upload) in {secs:.3f} s: "
        f"{A_dev.n_slots:,} slots for {A_dev.nnz:,} nonzeros, padding ratio "
        f"{A_dev.padding:.6f}, slice widths {int(widths.min())}..{int(widths.max())}")
    check_sell_kernels(torch, A_dev, A, record)

    def expect(restarts, iters):
        if (restarts, iters) != MESH_TPU_HISTORY:
            return f"history {restarts}/{iters}, the TPU reference's is {MESH_TPU_HISTORY}"
        return None

    counts, xs, _ = run_main_path(torch, "mesh3d", A, A_dev, expect)
    return counts, A, A_dev, xs["mixed"]


def exact_ilu(A_csr, dt, n_seg=None):
    """ExactILUDIAPrec of A in dt: fused, or split into n_seg segments (the
    budget set to an n_seg-th of the working set)."""
    from gmres_tpu_torch.precond import build as pb

    ws = (2 + 2 + 5) * dt.itemsize * A_csr.n_rows  # convdiff: 2 bands per triangle
    old = pb._TRISOLVE_L2_BYTES
    pb._TRISOLVE_L2_BYTES = 1 << 62 if n_seg is None else -(-ws // n_seg)
    try:
        M = pb.build_ilu_exact(A_csr, dt)
    finally:
        pb._TRISOLVE_L2_BYTES = old
    require(isinstance(M, pb.ExactILUDIAPrec) and (M.seg > 0) == (n_seg is not None),
            f"exact ILU of convdiff in {dt} is the {'segmented' if n_seg else 'fused'} K6 form")
    return M


def level_barrier_ms(torch, timer, mode, blocks):
    """Device time of one empty barrier of K6's sync mode `mode` on `blocks`
    blocks of 1024 threads (SYNC_PROBE barriers in one launch)."""
    from gmres_tpu_torch.ops.cuda.trisolve_kernel import level_sync_probe

    return timer(lambda: level_sync_probe(mode, blocks, SYNC_PROBE), 5) / SYNC_PROBE


def substitution_flops(torch, M):
    """Operations of one exact substitution on M's bands: a multiply and an
    add per stored nonzero whose column is in range, a subtraction a row in
    each phase and the U phase's multiply by D^-1."""
    n = M.inv_diag.shape[0]
    nnz = 0
    for bands, offs in ((M.lower_bands, M.offs_l), (M.upper_bands, M.offs_u)):
        for d, off in enumerate(offs):
            lo, hi = max(0, -off), min(n, n - off)
            nnz += int((bands[d, lo:hi] != 0).sum())
    return 2 * nnz + (n if M.offs_l else 0) + 2 * n


def trisolve_library(torch, timer, A_csr, dt, w, x_kernel):
    """One-call yardstick of K6: two CSR torch.triangular_solve calls (L
    unitriangular, then U with its diagonal) on the factors of A in dt; its
    time, or None (with the reason) where torch refuses.  The port never
    calls it."""
    from gmres_tpu_torch.precond import build as pb

    _, _, _, lower, upper, _ = pb._factors(A_csr, dt)
    Lt, Ut = csr_tensor(torch, lower, dt), csr_tensor(torch, upper, dt)
    W = w.view(-1, 1)

    def two():
        y = torch.triangular_solve(W, Lt, upper=False, unitriangular=True).solution
        return torch.triangular_solve(y, Ut, upper=True).solution

    try:
        x = two().view(-1)
    except (RuntimeError, NotImplementedError) as e:
        log(f"  torch.triangular_solve on CSR factors ({dt}): refused ({str(e)[:160]})")
        return None
    diff = float((x - x_kernel).abs().max() / x_kernel.abs().max())
    log(f"  torch.triangular_solve x2 ({dt}): max rel diff to K6 {diff:.3e}")
    return timer(two, TRISOLVE_REPS)


def check_trisolve_kernels(torch, A_csr, record):
    """K6 fused and segmented (2 segments, as the fp64 solve at 1M) against
    their plain versions at convdiff@1M's factor shapes, fp32 and fp64: bit
    for bit (each row once from final inputs, every product and sum rounded
    once), fused and segmented the same bits, a repeat the same bits.  The
    tolerance scale is the same recurrence on absolute values: -|bands|,
    |D^-1| and |w| (every term added).  Beside the bound: the old design's
    floor (every level a barrier of the resident 256-thread cooperative
    grid, plus one), each sync candidate's empty barrier and the kernel's
    time on its two forms."""
    from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk

    n = A_csr.n_rows
    w_np = np.random.default_rng(2).standard_normal(n)
    timer = Timer(torch)
    props = torch.cuda.get_device_properties(0)
    resident = props.multi_processor_count * (props.max_threads_per_multi_processor // 256)
    old_sync = barrier_ms(torch, timer, resident)
    syncs = {}
    for mode, blocks in LEVEL_SYNCS:
        syncs[(mode, blocks)] = level_barrier_ms(torch, timer, mode, blocks)
        log(f"  K6 sync candidate {mode} x {blocks} blocks of 1024: empty barrier "
            f"{1e3 * syncs[(mode, blocks)]:.3f} us")
    log(f"  old design's barrier: grid.sync() of the resident grid of {resident} blocks of "
        f"256: {1e3 * old_sync:.3f} us")
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        w = torch.tensor(w_np, dtype=dt, device="cuda")
        outs = {}
        for kname, M in (("ilu_trisolve_fused", exact_ilu(A_csr, dt)),
                         ("ilu_trisolve_segmented", exact_ilu(A_csr, dt, n_seg=2))):
            M = M.to("cuda")
            S = M.schedule
            fn_cuda = getattr(tk, kname + "_cuda")
            fn_plain = getattr(tk, kname + "_plain")
            steps = ((M.steps_l_segs, M.steps_u_segs, M.seg) if M.seg
                     else (M.steps_l, M.steps_u))
            args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u, *steps)
            abs_args = (-M.lower_bands.abs(), -M.upper_bands.abs(), M.inv_diag.abs(), w.abs(),
                        M.offs_l, M.offs_u, *steps)
            got, want = fn_cuda(*args, schedule=S), fn_plain(*args)
            bit = torch.equal(got, want)
            require(torch.equal(fn_cuda(*args, schedule=S), got), f"{kname} {dt_name}: repeats")
            outs[kname] = got
            scale = fn_plain(*abs_args)
            ms = timer(lambda: fn_cuda(*args, schedule=S), TRISOLVE_REPS)
            mode, blocks = fn_cuda.grid
            sync = syncs.get((mode, blocks)) or level_barrier_ms(torch, timer, mode, blocks)
            d_l, d_u = len(M.offs_l), len(M.offs_u)
            levels = (S.nlev_l if d_l else 0) + S.nlev_u
            # one barrier after every level but the last (csrc/ilu_trisolve.cu)
            barriers = levels - 1
            sweeps = (sum(M.steps_l_segs) + sum(M.steps_u_segs) if M.seg
                      else M.steps_l + M.steps_u)
            old_floor = (sweeps + 1) * old_sync
            log(f"  {kname} {dt_name}: {levels} levels (widest {max(S.width_l, S.width_u)} "
                f"rows) in one launch on {mode} x {blocks}, {1e3 * ms / levels:.3f} us a level, "
                f"{barriers} barriers of {1e3 * sync:.3f} us; bit-equal to the plain version: "
                f"{bit}; old design's floor {sweeps + 1} x {1e3 * old_sync:.3f} us = "
                f"{old_floor:.4f} ms, kernel/floor {ms / old_floor:.3f}"
                + (f"; segments of {M.seg}" if M.seg else ""))
            # bytes: the bands, D^-1 and w read once and x written once;
            # operations: one substitution's
            nbytes = (d_l + d_u + 3) * n * dt.itemsize
            lib_ms = trisolve_library(torch, timer, A_csr, dt, w, got)
            err, tol, ok = compare(dt_name, [got], [want], [scale])
            record(kname, dt_name, err, tol, ok and bit, ms,
                   timer(lambda: fn_plain(*args), TRISOLVE_PLAIN_REPS), nbytes,
                   substitution_flops(torch, M), lib_ms, barrier_ms=barriers * sync)
            torch.cuda.synchronize()
            del got, want, scale
        require(torch.equal(outs["ilu_trisolve_fused"], outs["ilu_trisolve_segmented"]),
                f"K6 {dt_name}: fused and segmented give the same bits")
        # the fused form on each of its sync forms: the same bits, its time
        M = exact_ilu(A_csr, dt).to("cuda")
        args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u, M.steps_l,
                M.steps_u)
        for cand in (c for c in LEVEL_SYNCS if c[0] in tk.SYNC_MODES):
            out = tk.ilu_trisolve_fused_cuda(*args, schedule=M.schedule, sync=cand)
            require(torch.equal(out, outs["ilu_trisolve_fused"]),
                    f"K6 {dt_name} on {cand}: the same bits")
            ms = timer(lambda: tk.ilu_trisolve_fused_cuda(*args, schedule=M.schedule,
                                                          sync=cand), TRISOLVE_REPS)
            log(f"  K6 fused {dt_name} on {cand[0]} x {tk.ilu_trisolve_fused_cuda.grid[1]}: "
                f"{ms:.4f} ms; bits equal")
        del M, outs
    record.require_ok()
    k6_form_table(torch, timer, NX_WIDE)


def k6_form_table(torch, timer, nx):
    """K6 fused on convdiff(nx) (widest level nx rows) in fp32 and fp64 on
    each of its forms (one block, cooperative grids): the same bits as the
    level twin on each, and the time of each."""
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk

    A = convection_diffusion_2d(nx, beta=2.0)
    w_np = np.random.default_rng(3).standard_normal(A.n_rows)
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        M = exact_ilu(A, dt).to("cuda")
        S = M.schedule
        w = torch.tensor(w_np, dtype=dt, device="cuda")
        args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u, M.steps_l,
                M.steps_u)
        want = tk.ilu_trisolve_levels_plain(S, w)
        picked = tk.level_grid(max(S.width_l, S.width_u))
        levels = S.nlev_l + S.nlev_u
        for form in K6_FORMS:
            out = tk.ilu_trisolve_fused_cuda(*args, schedule=S, sync=form)
            require(torch.equal(out, want), f"K6 {dt_name} at convdiff({nx}) on {form}: "
                    f"the level twin's bits")
            ms = timer(lambda: tk.ilu_trisolve_fused_cuda(*args, schedule=S, sync=form),
                       TRISOLVE_REPS)
            log(f"  K6 form table convdiff({nx}) {dt_name} (widest {max(S.width_l, S.width_u)}, "
                f"{levels} levels) on {form[0]} x {tk.ilu_trisolve_fused_cuda.grid[1]}"
                f"{' (picked)' if form == picked else ''}: {ms:.4f} ms, "
                f"{1e3 * ms / levels:.3f} us a level; bits equal")
        del M, S, w, want


def k6_beside_checkout(torch, A_csr, checkout):
    """K6 of this checkout beside K6 of another (``checkout``: its kernel
    library built there by its own build, its wrappers and level schedule
    loaded from its source) on the same factors and w: fused and segmented
    (2 segments), fp32 and fp64, the same bits, and the device times in
    alternating turns under one Timer (pairs of TRISOLVE_REPS launches)."""
    import importlib.util
    from pathlib import Path

    from gmres_tpu_torch.ops.cuda import _build
    from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk

    root = Path(checkout).resolve()
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, "-c", "from gmres_tpu_torch.ops.cuda._build import library; "
         "print(library().path)"], cwd=root, capture_output=True, text=True, check=True)
    other_lib = _build.KernelLibrary(Path(built.stdout.strip().splitlines()[-1]), "", 0.0)
    spec = importlib.util.spec_from_file_location(
        "k6_other_checkout", root / "gmres_tpu_torch" / "ops" / "cuda" / "trisolve_kernel.py")
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other  # its dataclasses look their module up there
    spec.loader.exec_module(other)
    other.library = lambda: other_lib
    log(f"K6 beside {root}: its library {other_lib.path} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    timer = Timer(torch)
    w_np = np.random.default_rng(2).standard_normal(A_csr.n_rows)
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        w = torch.tensor(w_np, dtype=dt, device="cuda")
        for kname, n_seg in (("ilu_trisolve_fused", None), ("ilu_trisolve_segmented", 2)):
            M = exact_ilu(A_csr, dt, n_seg).to("cuda")
            steps = ((M.steps_l_segs, M.steps_u_segs, M.seg) if M.seg
                     else (M.steps_l, M.steps_u))
            args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u, *steps)
            S_other = other.level_schedule(M.lower_bands, M.upper_bands, M.inv_diag, M.offs_l,
                                           M.offs_u, M.seg).to("cuda")
            fns = {"this": lambda: getattr(tk, kname + "_cuda")(*args, schedule=M.schedule),
                   "other": lambda: getattr(other, kname + "_cuda")(*args, schedule=S_other)}
            require(torch.equal(fns["this"](), fns["other"]()),
                    f"K6 {kname} {dt_name}: the same bits as {root}'s")
            times = {"this": [], "other": []}
            for turn in range(K6_BESIDE_PAIRS):
                for side in (("this", "other") if turn % 2 == 0 else ("other", "this")):
                    times[side].append(timer(fns[side], TRISOLVE_REPS))
            med = {k: statistics.median(v) for k, v in times.items()}
            faster = sum(a < b for a, b in zip(times["this"], times["other"]))
            log(f"  K6 {kname} {dt_name}: this {med['this']:.4f} ms, {root.name} "
                f"{med['other']:.4f} ms (medians of {K6_BESIDE_PAIRS} turns; this faster in "
                f"{faster} of {K6_BESIDE_PAIRS}; this/other {med['this'] / med['other']:.4f}); "
                f"bits equal")
            del M, S_other


def convdiff_ilu_path(torch, record, A, A_dev):
    """ILU-Jacobi(3) and exact ILU at convdiff@1M and exact ILU at 262K, M
    built on the host from the CSR matrix and passed as M=; returns the
    launch counts of the path's solves."""
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gmres_tpu_torch.ops.dia import DIAMatrix
    from gmres_tpu_torch.precond.build import (
        ExactILUDIAPrec,
        build_preconditioner,
        optimize_precond_format,
    )
    from gmres_tpu_torch.precond.ilu0 import ilu0_factorize, triangular_level_counts

    rp, ci, v = A.numpy_arrays()
    t0 = time.perf_counter()
    _, diag = ilu0_factorize(rp, ci, v)
    t1 = time.perf_counter()
    levels = triangular_level_counts(rp, ci, diag)
    log(f"host ILU(0) of convdiff@1M (C++ helper, built at first use): "
        f"{t1 - t0:.3f} s; dependency levels (L, U) {levels} in "
        f"{time.perf_counter() - t1:.3f} s")
    check_trisolve_kernels(torch, A, record)

    def build_m(label, A_csr, cfg):
        t0 = time.perf_counter()
        M = optimize_precond_format(build_preconditioner(A_csr, cfg)).to("cuda")
        torch.cuda.synchronize()
        if not isinstance(M, ExactILUDIAPrec):
            form = f"{type(M.lower).__name__} factors, {M.steps} sweeps"
        elif M.seg:
            form = f"segmented: {M.seg}-row segments, sweeps {M.steps_l_segs}"
        else:
            form = f"fused: sweeps {(M.steps_l, M.steps_u)}"
        log(f"M {label} {cfg.precision.precond}: {type(M).__name__} ({form}) "
            f"built and uploaded in {time.perf_counter() - t0:.3f} s")
        return M

    t0 = time.perf_counter()
    A262 = convection_diffusion_2d(NX_262K, beta=2.0)
    A262_dev, secs = stage_timed(torch, A262)
    require(isinstance(A262_dev, DIAMatrix), "convdiff@262K stages as DIA")
    log(f"matrix: convection_diffusion_2d({NX_262K}, beta=2.0) n={A262.n_rows:,} built and "
        f"staged in {time.perf_counter() - t0:.2f} s")

    reset_launch_counts()
    for mode in ("baseline", "mixed"):
        t0 = time.perf_counter()
        cfg = config(mode, "ilu_jacobi", jacobi_steps=3)
        M = build_m("convdiff@1M ilu_jacobi(3)", A, cfg)
        require(isinstance(M.lower, DIAMatrix), "ILU-Jacobi factors repack to DIA")
        res, _ = solve_timed(torch, "convdiff@1M ilu_jacobi(3)", mode, A, A_dev, cfg, 1,
                             M=M, warm_up=False)
        want = ILU_JACOBI_HISTORY[mode]
        lo, hi = ILU_JACOBI_RESTARTS[mode]
        log(f"  vs the reference's {want[0]}/{want[1]}: restarts {res.restarts - want[0]:+d} "
            f"(held to {lo}..{hi}); phase {time.perf_counter() - t0:.1f} s")
        require(lo <= res.restarts <= hi,
                f"ilu_jacobi {mode}: {res.restarts}/{res.total_iters} restarts not in "
                f"{lo}..{hi} (the reference's {want[0]}/{want[1]})")
        if mode == "baseline":
            twin = solve_with_plain(torch, A, A_dev, cfg, M, "gram")
            twin3 = solve_with_plain(torch, A, A_dev, cfg, M, "update_gram")
            log(f"  the same solve with K2's plain version (torch.mv): "
                f"{twin.restarts}/{twin.total_iters}; with K3 GRAM's (torch.mv): "
                f"{twin3.restarts}/{twin3.total_iters}")
            require((twin.restarts, twin.total_iters) == (res.restarts, res.total_iters),
                    f"ilu_jacobi baseline: {res.restarts}/{res.total_iters} on K2, "
                    f"{twin.restarts}/{twin.total_iters} on its plain version")
    exact_walls = []
    for label, A_csr, A_staged in (("convdiff@262K ilu", A262, A262_dev),
                                   ("convdiff@1M ilu", A, A_dev)):
        for mode in ("baseline", "mixed"):
            t0 = time.perf_counter()
            cfg = config(mode, "ilu")
            M = build_m(label, A_csr, cfg)
            require(isinstance(M, ExactILUDIAPrec), f"{label} {mode}: exact ILU on K6")
            res, wall = solve_timed(torch, label, mode, A_csr, A_staged, cfg, 1, M=M,
                                    history=True, warm_up=False)
            exact_walls.append(f"{label} {mode} {wall:.4f} s ({res.restarts}/{res.total_iters}"
                               f", {'segmented' if M.seg else 'fused'})")
            if A_csr is A262 and mode == "mixed":
                want = EXACT_262K_HISTORY
                log(f"  vs the reference's {want[0]}/{want[1]}: restarts "
                    f"{res.restarts - want[0]:+d}")
                require(abs(res.restarts - want[0]) <= 1,
                        f"{label} mixed: {res.restarts}/{res.total_iters} not within one "
                        f"restart of {want[0]}/{want[1]}")
            log(f"  phase {time.perf_counter() - t0:.1f} s")
    log("exact ILU solve walls (restarts/iterations; the reference's 8/240 at 262K mixed): "
        + "; ".join(exact_walls))
    counts = launch_counts()
    log(f"  launches convdiff-ilu: {counts}")
    require(all(counts[k] > 0 for k in ILU_KERNELS + PATH_KERNELS["convdiff"]),
            f"convdiff-ilu: K1 and both K6 forms launched ({counts})")
    require(all(counts[k] == 0 for k in PATH_KERNELS["mesh3d"] + MGS_KERNELS),
            f"convdiff-ilu: K5 and the MGS kernels did not launch ({counts})")
    return counts

def apply_device_ms(torch, fn, reps=3):
    """Device time of one call of `fn` (a preconditioner apply of thousands
    of small torch launches, whose host enqueue outlasts its device work):
    the call captured once as a CUDA graph and each replay timed by CUDA
    events, the median of `reps`."""
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
        torch.cuda.synchronize()
        with torch.cuda.graph(g, stream=stream):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del g
    return statistics.median(times)


def bf16ilu_solve(torch, label, A_csr, A_dev, cfg, M, held, plain=0):
    """One solve of the convdiff-bf16ilu path (solve_timed, one timed run,
    no warm-up) with its bf16 and fp32 phases logged.  It must converge
    within BF16ILU_MAX_RESTARTS, and its (restarts before the escalation,
    all restarts) lie within STALL_WINDOW and BF16ILU_SLACK of `held`
    (BF16ILU_CPU or BF16ILU_1M); a non-zero `plain` runs the same solve
    with CGSR's sweeps on their plain versions, held to this solve's bf16
    phase within STALL_WINDOW and its total within `plain`.  Returns
    (result, bf16 restarts)."""
    def phases(r):
        marks = [i for i, h in enumerate(r.history) if h.get("escalated")]
        return marks[0] if marks else r.restarts

    def hold(r, want, slack, what):
        # a solve that stops in its bf16 phase tests the norm of the residual
        # rounded to bf16: its fp64 backward error is held to twice the tolerance
        limit = TOL if r.escalated or cfg.precision.inner != "bfloat16" else 2 * TOL
        before = phases(r)
        log(f"  {label}{what}: converged={r.converged} escalated={r.escalated} restarts "
            f"{before} before the escalation, {r.restarts - before} after; backward error "
            f"{r.backward_error:.3e}; bf16 phase {before} vs {want[0]}, total {r.restarts} "
            f"vs {want[1]}")
        require(r.converged and r.backward_error <= limit
                and abs(before - want[0]) <= STALL_WINDOW and abs(r.restarts - want[1]) <= slack,
                f"{label}{what}: converged={r.converged} at a backward error "
                f"{r.backward_error:.3e} (<= {limit:.0e}), bf16 phase {before} and total "
                f"{r.restarts} not within {STALL_WINDOW} and {slack} of {want}")
        return before

    res, _ = solve_timed(torch, label, "bf16ilu", A_csr, A_dev, cfg, 1, M=M, history=True,
                         converges=False, warm_up=False)
    before = hold(res, held, BF16ILU_SLACK, "")
    if plain:
        twin = solve_with_plain(torch, A_csr, A_dev, cfg, M, "gram", "update_gram",
                                "update_sumsq")
        hold(twin, (before, res.restarts), plain,
             " on the plain versions of its sweeps, against the kernels'")
    return res, before


def convdiff_bf16ilu_path(torch, A, A_dev):
    """The bf16 ILU preconditioners on one card: the bf16 ILU-Jacobi(3) apply
    against the CPU's at convdiff@1M, timed beside K1; ILU-Jacobi(3) at
    convdiff@1M in the bf16 tier (CGSR and sequential MGS: the bf16 phase,
    the stall and the fp32 continuation; CGSR also on the plain versions of
    K2 and K3) and with fp32 inner and the bf16 M (CGSR), held to
    BF16ILU_1M; the same three
    at convdiff(BF16ILU_NX) held to the JAX package's counts on the CPU
    (BF16ILU_CPU), bf16 CGSR there also on the plain versions; bf16 exact ILU at convdiff(512) on its sweep form, the
    apply's wall and device time beside K6 fp32's at the same size, a solve
    cut at BF16_EXACT_CUT restarts held to the JAX package's history on the
    CPU (BF16_EXACT_CPU); and the route bf16 exact ILU takes at 1M.  Returns
    the launch counts of the path's solves."""
    from gmres_tpu_torch import PrecisionSpec
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.cuda import (
        form_launch_counts,
        launch_counts,
        reset_launch_counts,
    )
    from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk
    from gmres_tpu_torch.ops.dia import DIAMatrix, dia_spmv
    from gmres_tpu_torch.precond import build as pb
    from gmres_tpu_torch.precond.apply import typesafe_apply

    bf16, f32 = torch.bfloat16, torch.float32
    t_path = time.perf_counter()

    def build_m(label, A_csr, cfg):
        t0 = time.perf_counter()
        M = pb.optimize_precond_format(pb.build_preconditioner(A_csr, cfg)).to("cuda")
        torch.cuda.synchronize()
        log(f"M {label}: {type(M).__name__} in {M.inv_diag.dtype} "
            f"({getattr(M, 'steps', '-')} sweeps) built and uploaded in "
            f"{time.perf_counter() - t0:.3f} s")
        return M

    def tier(name, precond="ilu_jacobi", **kw):
        spec = {"bf16": ("float64", "bfloat16", "bfloat16"),
                "fp32": ("float64", "float32", "bfloat16")}[name]
        return config("mixed", precond, jacobi_steps=3, **kw).with_(
            precision=PrecisionSpec(*spec), max_restarts=BF16ILU_MAX_RESTARTS)

    # the apply on the card against the CPU's (plain torch on both), timed
    M1 = build_m("convdiff@1M ilu_jacobi(3)", A, tier("bf16"))
    require(isinstance(M1.lower, DIAMatrix) and M1.lower.data.dtype == bf16,
            "bf16 ILU-Jacobi factors repack to bf16 DIA")
    timer = Timer(torch)
    w = torch.tensor(np.random.default_rng(8).standard_normal(A.n_rows), device="cuda")
    for dt in (bf16, f32):
        wd = w.to(dt)
        got = typesafe_apply(M1, wd)
        want = typesafe_apply(M1.to("cpu"), wd.cpu())
        err = float((got.cpu().double() - want.double()).abs().max())
        bound = 6 * BF16_ULP * float(want.abs().max())
        log(f"  bf16 ILU-Jacobi(3) apply to {str(dt)[6:]} w on the card against the CPU: "
            f"max abs err {err:.3e} (bound {bound:.3e}); device time "
            f"{apply_device_ms(torch, lambda: typesafe_apply(M1, wd)):.4f} ms")
        require(err <= bound, f"bf16 ILU-Jacobi apply ({dt}) on the card within {bound:.3e} "
                              f"of the CPU's")
    x32 = w.to(f32)
    A32 = A_dev.astype(f32)
    log(f"  K1 fp32 on the same operator: {timer(lambda: dia_spmv(A32, x32), 5):.4f} ms "
        f"(an ILU-Jacobi(3) apply is 6 bf16 SpMVs and 3 vector updates)")
    del A32, x32

    # bf16 exact ILU at 262K: the sweep form, its apply beside K6 fp32's
    A262 = convection_diffusion_2d(NX_262K, beta=2.0)
    A262_dev = stage_timed(torch, A262)[0]
    Me = build_m("convdiff@262K ilu (bf16)", A262, tier("bf16", precond="ilu"))
    require(isinstance(Me, pb.ILUJacobiPrec) and isinstance(Me.lower, DIAMatrix)
            and Me.inv_diag.dtype == bf16,
            "bf16 exact ILU at 262K is the sweep form (bf16 DIA factors), never K6")
    we = torch.randn(A262.n_rows, device="cuda", dtype=bf16)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        typesafe_apply(Me, we)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dev_ms = apply_device_ms(torch, lambda: typesafe_apply(Me, we))
    K6 = pb.build_ilu_exact(A262, f32).to("cuda")
    w32 = we.to(f32)
    k6_ms = timer(lambda: tk.ilu_trisolve_fused_cuda(
        K6.lower_bands, K6.upper_bands, K6.inv_diag, w32, K6.offs_l, K6.offs_u, K6.steps_l,
        K6.steps_u, schedule=K6.schedule), 3)
    log(f"bf16 exact ILU apply at 262K (sweep form, {Me.steps} sweeps a triangle): wall "
        f"median {1e3 * statistics.median(walls):.2f} ms {[round(1e3 * t, 2) for t in walls]}, "
        f"device time {dev_ms:.3f} ms (CUDA graph replay); K6 fp32 fused at 262K "
        f"{k6_ms:.4f} ms")
    del K6, w32, we

    # the route bf16 exact ILU takes at 1M
    t0 = time.perf_counter()
    try:
        route = type(pb.build_ilu_exact(A, bf16)).__name__
    except ValueError as e:
        route = f"refused ({e})"
    log(f"bf16 exact ILU at convdiff@1M: {route} (built in {time.perf_counter() - t0:.2f} s)")

    A256 = convection_diffusion_2d(BF16ILU_NX, beta=2.0)
    A256_dev = stage_timed(torch, A256)[0]
    M256 = build_m(f"convdiff({BF16ILU_NX}) ilu_jacobi(3)", A256, tier("bf16"))

    reset_launch_counts()
    t0 = time.perf_counter()
    for orth in ("cgsr", "mgs"):
        bf16ilu_solve(torch, f"convdiff@1M bf16 ilu_jacobi(3) {orth}", A, A_dev,
                      tier("bf16", orth=orth), M1, BF16ILU_1M[("bf16", orth)],
                      plain=BF16ILU_PLAIN_1M if orth == "cgsr" else 0)
    bf16ilu_solve(torch, "convdiff@1M fp32 inner, bf16 ilu_jacobi(3) cgsr", A, A_dev,
                  tier("fp32"), M1, BF16ILU_1M[("fp32", "cgsr")])
    log(f"  ILU-Jacobi(3) at 1M: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, orth in (("bf16", "cgsr"), ("bf16", "mgs"), ("fp32", "cgsr")):
        bf16ilu_solve(torch, f"convdiff({BF16ILU_NX}) {name} ilu_jacobi(3) {orth}", A256,
                      A256_dev, tier(name, orth=orth), M256, BF16ILU_CPU[(name, orth)],
                      plain=BF16ILU_SLACK if (name, orth) == ("bf16", "cgsr") else 0)
    log(f"  ILU-Jacobi(3) at convdiff({BF16ILU_NX}): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res, _ = solve_timed(torch, "convdiff@262K bf16 exact ilu cut", "bf16ilu", A262, A262_dev,
                         tier("bf16", precond="ilu").with_(max_restarts=BF16_EXACT_CUT), 1,
                         M=Me, history=True, converges=False, warm_up=False)
    hist = [h["rel_initial"] for h in res.history]
    log(f"  against the JAX package's on the CPU: {BF16_EXACT_CPU}; {time.perf_counter() - t0:.1f} s")
    require(res.restarts == BF16_EXACT_CUT and len(hist) == len(BF16_EXACT_CPU)
            and all(1 / BF16_EXACT_FACTOR <= g / w_ <= BF16_EXACT_FACTOR
                    for g, w_ in zip(hist, BF16_EXACT_CPU)),
            f"bf16 exact ILU at 262K: history {hist} not within {BF16_EXACT_FACTOR}x of the "
            f"JAX package's {BF16_EXACT_CPU}")
    counts, forms = launch_counts(), form_launch_counts()
    log(f"  launches convdiff-bf16ilu: {counts}")
    log(f"  form launches convdiff-bf16ilu: {forms}")
    own = ("dia_spmv", "dia_residual", "basis_gram", "basis_update_gram", "basis_update_sumsq",
           "basis_mgs", "basis_axpy")
    idle = (*PATH_KERNELS["mesh3d"], *ILU_KERNELS, "basis_gram2", "basis_update",
            *DF64_KERNELS, *DIST_KERNELS)
    require(all(counts[k] > 0 for k in own) and all(counts[k] == 0 for k in idle),
            f"convdiff-bf16ilu: K1, K2, K3 GRAM/SUMSQ, K7 and K4 launched; no K5, K6, K2x2, "
            f"K3 plain, K8-K12 ({counts})")
    require(forms["basis_gram"].get("bf16_bf16", 0) > 0 and forms["basis_gram"].get("f32", 0) > 0
            and forms["basis_mgs"].get("bf16_bf16", 0) > 0
            and forms["dia_spmv"].get("f32", 0) > 0,
            f"convdiff-bf16ilu: K2 in (bf16, bf16) and fp32, K7 in (bf16, bf16), K1 in fp32 "
            f"({forms})")
    log(f"  convdiff-bf16ilu phase seconds {time.perf_counter() - t_path:.1f}")
    return counts


MID_ROWS = 16          # the middle basis height of K7/K2x2/K3-plain checks
ORTH_WALL_REPS = 1     # timed solves per form and mode, after a warm-up
GRID_BLOCKS_PER_SM = (1, 2, 4, 0)  # K7 grids measured (0: every resident block)


def mgs_scale(torch, V, w, rows):
    """The MGS recurrence on absolute values, with the coefficients h_j of
    the recurrence itself: sw_j = |w| + sum_{i<j} |h_i| |v_i| bounds the
    terms that make w_j, <sw_j, |v_j|> those that make h_j.  The scale of
    h, of w' and of ||w'|| for the tolerance.  (Adding |<sw_j, |v_j|>| |v_j|
    instead would grow ~1.6x a row on a near-orthonormal basis of positive
    |v_j|, far beyond any error of the recurrence.)"""
    sw = w.abs()
    wj = w.clone()
    sh = torch.zeros(V.shape[0], dtype=V.dtype, device=V.device)
    for j in range(rows):
        a = V[j].abs()
        sh[j] = torch.dot(sw, a)
        hj = torch.dot(wj, V[j])
        wj -= hj * V[j]
        sw = sw + hj.abs() * a
    return sh, sw, torch.sqrt(torch.dot(sw, sw))


def mgs_basis(torch, n, dt, seed):
    """A 31-row basis of near-orthonormal rows (N(0, 1/n) entries), w and u."""
    rng = np.random.default_rng(seed)
    m1 = RLEN + 1
    V = torch.tensor(rng.standard_normal((m1, n)) / np.sqrt(n), dtype=dt, device="cuda")
    w = torch.tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    u = torch.tensor(rng.standard_normal(m1), dtype=dt, device="cuda")
    return V, w, u


def check_mgs_kernels(torch, n, record):
    """K7, K2x2 and K3 plain mode against their plain versions at
    convdiff@1M's shapes (fp32, fp64; a 31-row basis at rows 31 and 16).
    One call computes K2x2 (torch.mm against an (n, 2) matrix) and K3 plain
    (torch.addmv); none computes K7."""
    from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_

    timer = Timer(torch)
    m1 = RLEN + 1
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        s = dt.itemsize
        V, w, u = mgs_basis(torch, n, dt, 3)
        for rows in (m1, MID_ROWS):
            key = dt_name if rows == m1 else f"{dt_name} rows {rows}"
            got = mk.mgs_cuda(V, w, rows)
            blocks, tiles = mk.mgs_cuda.grid
            sync = barrier_ms(torch, timer, blocks)
            group, n_groups = mk.mgs_groups(n)
            log(f"  basis_mgs {key}: one launch of {blocks} blocks x {tiles} register tiles, "
                f"{rows} row exchanges through {n_groups} tagged slots (groups of {group} "
                f"tiles); one grid.sync() of this grid, what a row waited on before: "
                f"{1e3 * sync:.3f} us")
            record("basis_mgs", dt_name,
                   *compare_each(dt_name, got, mk.mgs_plain(V, w, rows),
                                 mgs_scale(torch, V, w, rows)),
                   timer(lambda: mk.mgs_cuda(V, w, rows)),
                   timer(lambda: mk.mgs_plain(V, w, rows), 5), (rows + 2) * n * s,
                   (4 * rows + 2) * n, None, key=key)

            vk = V[rows - 1]
            W = torch.stack([w, vk], dim=1)
            u0, u1 = ok_.gram2_cuda(V, w, vk, rows).unbind(1)
            require(torch.equal(u0, ok_.gram_cuda(V, w, rows))
                    and torch.equal(u1, ok_.gram_cuda(V, vk, rows)),
                    f"K2x2 {key}: u0 and u1 bit-equal to K2's u of w and of row {rows - 1}")
            record("basis_gram2", dt_name,
                   *compare_each(dt_name, ok_.gram2_cuda(V, w, vk, rows).unbind(1),
                                 ok_.gram2_plain(V, w, vk, rows).unbind(1),
                                 ok_.gram2_plain(V.abs(), w.abs(), vk.abs(), rows).unbind(1)),
                   timer(lambda: ok_.gram2_cuda(V, w, vk, rows)),
                   timer(lambda: ok_.gram2_plain(V, w, vk, rows)), (rows + 2) * n * s,
                   4 * rows * n, timer(lambda: torch.mm(V[:rows], W)), key=key)

            sw = w.abs() + torch.mv(V[:rows].abs().t(), u[:rows].abs())
            record("basis_update", dt_name,
                   *compare_each(dt_name, [ok_.update_cuda(V, w, u, rows)],
                                 [ok_.update_plain(V, w, u, rows)], [sw]),
                   timer(lambda: ok_.update_cuda(V, w, u, rows)),
                   timer(lambda: ok_.update_plain(V, w, u, rows)), (rows + 2) * n * s,
                   2 * rows * n, timer(lambda: torch.addmv(w, V[:rows].t(), u[:rows],
                                                           alpha=-1)), key=key)
        torch.cuda.synchronize()
        del V, w, u, W
    record.require_ok()


def mgs_grid_table(torch, n, copy_gbs):
    """K7 at n on a few grids (blocks per SM; and the L2 form on the
    dtype's grid), fp32 and fp64, rows 16 and 31, each with both ways of
    awaiting a row's partials (a grid.sync(), or polling the tagged slots):
    time, grid and the bound, beside one grid.sync() of that grid; every
    result bit-identical to the first."""
    from gmres_tpu_torch.ops.cuda import mgs_kernel as mk

    timer = Timer(torch)
    log("K7 grid sizes (ms; bound = bytes / copy):")
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        V, w, _ = mgs_basis(torch, n, dt, 4)
        for rows in (MID_ROWS, RLEN + 1):
            ref = None
            for per_sm, tiles_max in [(p, mk.MAX_REGISTER_TILES) for p in GRID_BLOCKS_PER_SM] + \
                    [(mk.BLOCKS_PER_SM[dt], 0)]:
                sync = None
                for mode, ex in (("sync", mk.SYNC), ("poll", mk.POLL)):
                    out = mk.mgs_cuda(V, w, rows, per_sm, tiles_max, ex)
                    blocks, tiles = mk.mgs_cuda.grid
                    ref = ref or out
                    require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                            f"K7 bit-identical across grids ({dt_name}, rows {rows}, "
                            f"{blocks} blocks, {mode})")
                    ms = timer(lambda: mk.mgs_cuda(V, w, rows, per_sm, tiles_max, ex))
                    sync = sync or barrier_ms(torch, timer, blocks)
                    bound = (rows + 2) * n * dt.itemsize / (copy_gbs * 1e9) * 1e3
                    chosen = (per_sm, tiles_max, ex) == (mk.BLOCKS_PER_SM[dt],
                                                         mk.MAX_REGISTER_TILES, mk.EXCHANGE[dt])
                    log(f"  K7 {dt_name} rows {rows:2d} blocks/SM {per_sm or 'all'} "
                        f"{'L2 form' if tiles == 0 else f'{tiles} tiles/block'} {mode}: "
                        f"{blocks:5d} blocks {ms:.4f} ms, bound {bound:.4f} ms "
                        f"({ms / bound:.2f}x), {1e3 * ms / rows:.3f} us a row; grid.sync() "
                        f"{1e3 * sync:.3f} us" + ("  <- the dtype's default" if chosen else ""))
        del V, w


def mgs_step_walls(torch, n):
    """Host wall per Arnoldi orthogonalization step (k = 0..29 in turn,
    median of 5 sweeps, ending in a device sync) of sequential MGS (K7),
    ICWY (K2x2, solve, K3 SUMSQ) and CGSR (K2, K3 GRAM, K3 SUMSQ)."""
    from gmres_tpu_torch.ops.orth import mgs_lowsync_step, orthonormalize_step

    out = {}
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        V, w, _ = mgs_basis(torch, n, dt, 5)
        L = torch.zeros((RLEN + 1, RLEN + 1), dtype=dt, device="cuda")

        def seq():
            for k in range(RLEN):
                orthonormalize_step("mgs", V, k, w)

        def icwy():
            for k in range(RLEN):
                mgs_lowsync_step(V, k, w, L)

        def cgsr():
            for k in range(RLEN):
                orthonormalize_step("cgsr", V, k, w)

        for form, fn in (("sequential", seq), ("icwy", icwy), ("cgsr", cgsr)):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[(dt_name, form)] = statistics.median(times) / RLEN * 1e3
        log(f"orthogonalization step wall ({dt_name}, mean over k = 0..{RLEN - 1}): "
            + ", ".join(f"{f} {out[(dt_name, f)]:.4f} ms"
                        for f in ("sequential", "icwy", "cgsr")))
        del V, w, L
    return out


def orth_solve_walls(torch, A, A_dev):
    """Walls of whole solves with sequential MGS, ICWY MGS and CGSR, in
    both modes, interleaved (the order reversed every other round) so that
    host noise falls on all three alike; the evidence behind the
    low_sync_mgs=None rule on the card."""
    from gmres_tpu_torch import rand_vect, solve

    n = A.n_rows
    b = torch.tensor(-csr_residual(A, rand_vect(n, 42), np.zeros(n)), device="cuda")
    forms = {"sequential": dict(orth="mgs", low_sync_mgs=False),
             "icwy": dict(orth="mgs", low_sync_mgs=True), "cgsr": dict(orth="cgsr")}
    for mode in ("baseline", "mixed"):
        cfgs = {f: config(mode, "identity", **kw) for f, kw in forms.items()}
        walls = {f: [] for f in forms}
        for f in forms:
            solve(A_dev, b, cfgs[f])  # warm-up
        for rep in range(ORTH_WALL_REPS):
            for f in (list(forms) if rep % 2 == 0 else list(forms)[::-1]):
                t0 = time.perf_counter()
                solve(A_dev, b, cfgs[f])
                torch.cuda.synchronize()
                walls[f].append(time.perf_counter() - t0)
        med = {f: statistics.median(v) for f, v in walls.items()}
        log(f"solve walls {mode} (s, {ORTH_WALL_REPS} each after a warm-up"
            f"{', interleaved' if ORTH_WALL_REPS > 1 else ''}): "
            + "; ".join(f"{f} {walls_text(v)}" for f, v in walls.items())
            + f"; icwy/sequential {med['icwy'] / med['sequential']:.4f}, "
            f"sequential/cgsr {med['sequential'] / med['cgsr']:.4f}")


def convdiff_mgs_path(torch, record, A, A_dev, copy_gbs):
    """MGS (sequential on K7, ICWY on K2x2 + K3 SUMSQ) in both modes and the
    restart policies and orth_steps=3 in mixed, on the staged convdiff@1M
    operator; returns the launch counts of the path's solves."""
    from gmres_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    check_mgs_kernels(torch, A.n_rows, record)
    mgs_grid_table(torch, A.n_rows, copy_gbs)
    mgs_step_walls(torch, A.n_rows)

    reset_launch_counts()

    def run(label, mode, timed, converges=True, **kw):
        cfg = config(mode, "identity", **kw)
        before = launch_counts()
        res, wall = solve_timed(torch, f"convdiff-mgs {label}", mode, A, A_dev, cfg, timed,
                                history=True, converges=converges, warm_up=False)
        after = launch_counts()
        c = {k: after[k] - before[k] for k in after}
        log(f"  launches {label} {mode}: {c}")
        require(c["dia_spmv"] > 0 and c["dia_residual"] > 0, f"{label} {mode}: K1 launched")
        require(all(c[k] == 0 for k in PATH_KERNELS["mesh3d"] + ILU_KERNELS),
                f"{label} {mode}: neither K5 nor K6 launched ({c})")
        return res, wall, c, timed

    for mode in ("baseline", "mixed"):
        for form, lowsync in (("sequential", False), ("icwy", True)):
            res, _, c, solves = run(f"mgs {form}", mode, 1, orth="mgs", low_sync_mgs=lowsync)
            want = MGS_HISTORY
            log(f"  vs the reference's {want[0]}/{want[1]}: restarts {res.restarts - want[0]:+d}")
            require(abs(res.restarts - want[0]) <= 1,
                    f"mgs {form} {mode}: {res.restarts}/{res.total_iters} not within one "
                    f"restart of {want[0]}/{want[1]}")
            # FIXED: every cycle enqueues m steps, so steps == iterations
            steps = solves * res.total_iters
            if lowsync:
                ok = c["basis_gram2"] == c["basis_update_sumsq"] == steps and c["basis_mgs"] == 0
            else:
                ok = c["basis_mgs"] == steps and c["basis_gram2"] == c["basis_update_sumsq"] == 0
            require(ok and c["basis_gram"] == c["basis_update_gram"] == c["basis_update"] == 0,
                    f"mgs {form} {mode}: its kernels once per step ({steps}), no other sweep "
                    f"({c})")
    orth_solve_walls(torch, A, A_dev)

    def cgsr_only(c, label, gram_per_step=1):
        require(c["basis_mgs"] == c["basis_gram2"] == c["basis_update"] == 0
                and c["basis_update_gram"] > 0
                and c["basis_gram"] == gram_per_step * c["basis_update_gram"],
                f"{label}: the CGSR sweeps, {gram_per_step} K2 a step, no MGS kernel ({c})")

    for policy, per_step in (("relres", 1), ("orthloss", 2)):
        res, _, c, _ = run(policy, "mixed", 1, policy=policy, restart_improvement=1e-2)
        want = POLICY_ITERS[policy]
        log(f"  {policy} vs the reference's {want} iterations: {res.total_iters - want:+d}; "
            f"cycle lengths {[h['k'] for h in res.history]}")
        require(abs(res.total_iters - want) <= RLEN,
                f"{policy}: {res.restarts}/{res.total_iters} not within {RLEN} iterations "
                f"of {want}")
        cgsr_only(c, policy, per_step)

    res, _, c, _ = run("repeat", "mixed", 1, converges=False, policy="repeat",
                       restart_improvement=1e-2)
    ks = [h["k"] for h in res.history]
    want = REPEAT_HISTORY
    log(f"  repeat: aborted={res.aborted} {res.restarts}/{res.total_iters}, first cycle "
        f"{ks[0]}, the reference's {want[0]}/{want[1]} with k = {want[2]}")
    require(res.aborted and not res.converged and res.restarts == want[0],
            f"repeat: aborts at {want[0]} restarts ({res.restarts}/{res.total_iters})")
    require(all(k == ks[0] for k in ks), f"repeat: every cycle has the first's length ({ks})")
    cgsr_only(c, "repeat")

    res, _, c, _ = run("cgsr orth_steps=3", "mixed", 1, orth_steps=3)
    log(f"  orth_steps=3: {res.restarts}/{res.total_iters} (no reference record)")
    require(c["basis_update"] > 0 and c["basis_update"] == c["basis_gram"]
            and c["basis_update_gram"] == c["basis_update_sumsq"] == 0
            and c["basis_mgs"] == c["basis_gram2"] == 0,
            f"orth_steps=3: K2 and K3 plain once per pass, no fused CGSR or MGS sweep ({c})")
    counts = launch_counts()
    log(f"  launches convdiff-mgs: {counts}")
    return counts


def df64_pair_basis(torch, n, seed):
    """The 31-row basis of mgs_basis as fp32 pairs, w as a pair, u in fp64;
    with V and w in fp64 for the tolerance scales."""
    from gmres_tpu_torch.ops.eft import split_f64

    V, w, u = mgs_basis(torch, n, torch.float64, seed)
    return (*split_f64(V), *split_f64(w), u, V, w)


def check_df64_kernels(torch, A_csr, record):
    """K8, K9-K11 (rows 31 and 16 of a 31-row basis) and K4's pair mode
    (30 rows) against their plain versions at convdiff@1M's shapes.  K8 and
    the updated pair of K10/K11 must equal the plain versions bit for bit;
    the sums over n are held to 2^-46 of the terms' magnitudes.  No single
    PyTorch call computes any of them."""
    from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk
    from gmres_tpu_torch.ops.cuda import df64_spmv_kernel as ds
    from gmres_tpu_torch.ops.cuda import outer_kernel as ou
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import DF64Dia, from_csr
    from gmres_tpu_torch.ops.eft import merge_f64, split_f64

    timer = Timer(torch)
    dia = from_csr(A_csr).to("cuda")
    n, D = dia.n_rows, len(dia.offsets)
    P = DF64Dia.from_dia(dia)
    dh, dl, offs = P.data_hi, P.data_lo, P.offsets
    x64 = torch.tensor(np.random.default_rng(6).standard_normal(n), device="cuda")
    xh, xl = split_f64(x64)
    got = ds.dia_spmv_df64_cuda(dh, dl, offs, xh, xl)
    want = ds.dia_spmv_df64_plain(dh, dl, offs, xh, xl)
    bit = all(torch.equal(g, w_) for g, w_ in zip(got, want))
    err, bound, ok = compare("df64", [merge_f64(*got)], [merge_f64(*want)],
                             [sk.dia_spmv_plain(dia.data.abs(), offs, x64.abs())])
    log(f"  dia_spmv_df64: bit-equal to the plain version: {bit}")
    record("dia_spmv_df64", "df64", err, bound, ok and bit,
           timer(lambda: ds.dia_spmv_df64_cuda(dh, dl, offs, xh, xl)),
           timer(lambda: ds.dia_spmv_df64_plain(dh, dl, offs, xh, xl), 5),
           (2 * D + 4) * 4 * n, DF_OPS * D * n)
    del dia, P, dh, dl, got, want

    Vh, Vl, wh, wl, u, V, w = df64_pair_basis(torch, n, 7)
    absV, absw = V.abs(), w.abs()
    m1 = RLEN + 1
    for rows in (m1, MID_ROWS):
        key = "df64" if rows == m1 else f"df64 rows {rows}"
        ur = u.clone()
        ur[rows:] = 0
        sw = absw + ur.abs() @ absV
        record("df_gram", "df64",
               *compare("df64", [dk.df_gram_cuda(Vh, Vl, wh, wl, rows)],
                        [dk.df_gram_plain(Vh, Vl, wh, wl, rows)], [absV @ absw]),
               timer(lambda: dk.df_gram_cuda(Vh, Vl, wh, wl, rows)),
               timer(lambda: dk.df_gram_plain(Vh, Vl, wh, wl, rows), 5),
               (2 * rows + 2) * 4 * n, DF_OPS * rows * n, key=key)
        for kname, scale, ops in (("df_update_gram", absV @ sw, 2 * DF_OPS * rows * n),
                                  ("df_update_sumsq", (sw * sw).sum(),
                                   DF_OPS * (rows + 1) * n)):
            fn_cuda, fn_plain = getattr(dk, kname + "_cuda"), getattr(dk, kname + "_plain")
            gh, gl, gs = fn_cuda(Vh, Vl, wh, wl, ur, rows)
            ph, pl, ps = fn_plain(Vh, Vl, wh, wl, ur, rows)
            bit = torch.equal(gh, ph) and torch.equal(gl, pl)
            log(f"  {kname} {key}: updated pair bit-equal to the plain version: {bit}")
            err, bound, ok = compare_each("df64", [gs], [ps], [scale])
            record(kname, "df64", err, bound, ok and bit,
                   timer(lambda: fn_cuda(Vh, Vl, wh, wl, ur, rows)),
                   timer(lambda: fn_plain(Vh, Vl, wh, wl, ur, rows), 5),
                   (2 * rows + 4) * 4 * n, ops, key=key)
            if kname == "df_update_gram":
                df_update_gram_table(torch, timer, Vh, Vl, wh, wl, ur, rows, (gh, gl, gs),
                                     record.copy_gbs)
    # K4 pair mode: x (fp64) += y^T (Vh + Vl)[:30], summed in fp64
    y = u[:RLEN].contiguous()
    x0 = torch.tensor(np.random.default_rng(8).random(n), device="cuda")
    got = ou.basis_axpy_pair_cuda(x0.clone(), Vh, Vl, y)
    want = ou.basis_axpy_pair_plain(x0.clone(), Vh, Vl, y)
    xk, xp = x0.clone(), x0.clone()
    record("basis_axpy", "float64",
           *compare("float64", [got], [want], [x0.abs() + y.abs() @ absV[:RLEN]]),
           timer(lambda: ou.basis_axpy_pair_cuda(xk, Vh, Vl, y)),
           timer(lambda: ou.basis_axpy_pair_plain(xp, Vh, Vl, y)), 2 * RLEN * 4 * n + 16 * n,
           3 * RLEN * n, key="pair")
    torch.cuda.synchronize()
    del Vh, Vl, wh, wl, u, V, w, absV, got, want
    record.require_ok()


def df64_step_walls(torch, n):
    """Host wall per df64 orthogonalization step (k = 0..29 in turn, median
    of 5 sweeps, ending in a device sync) of sequential MGS (a one-row K9
    and K11 per row), ICWY (two K9, an fp64 solve, K11) and CGSR (K9, K10,
    K11)."""
    from gmres_tpu_torch.ops import df64

    Vh, Vl, wh, wl, _, _, _ = df64_pair_basis(torch, n, 9)
    L = torch.zeros((RLEN + 1, RLEN + 1), dtype=torch.float64, device="cuda")
    forms = {
        "sequential": lambda k: df64.df_orthonormalize_step("mgs", Vh, Vl, k, wh, wl),
        "icwy": lambda k: df64.df_mgs_lowsync_step(Vh, Vl, k, wh, wl, L),
        "cgsr": lambda k: df64.df_orthonormalize_step("cgsr", Vh, Vl, k, wh, wl)}
    out = {}
    for form, step in forms.items():
        def sweep():
            for k in range(RLEN):
                step(k)
        sweep()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            sweep()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[form] = statistics.median(times) / RLEN * 1e3
    log("df64 orthogonalization step wall (mean over k = 0..29): "
        + ", ".join(f"{f} {v:.4f} ms" for f, v in out.items()))
    return out


def df64_solve_walls(torch, A, A_dev):
    """Walls of whole df64 solves (CGSR, CGS, MGS sequential and ICWY) and
    of the baseline CGSR solve, interleaved (the order reversed every other
    round): the df64/baseline ratio and the evidence behind the
    low_sync_mgs=None rule of df64 cycles on the card."""
    from gmres_tpu_torch import rand_vect, solve

    n = A.n_rows
    b = torch.tensor(-csr_residual(A, rand_vect(n, 42), np.zeros(n)), device="cuda")
    cfgs = {"baseline cgsr": config("baseline", "identity"),
            "df64 cgsr": config("df64", "identity"),
            "df64 cgs": config("df64", "identity", orth="cgs"),
            "df64 mgs sequential": config("df64", "identity", orth="mgs", low_sync_mgs=False),
            "df64 mgs icwy": config("df64", "identity", orth="mgs", low_sync_mgs=True)}
    walls = {f: [] for f in cfgs}
    for cfg in cfgs.values():
        solve(A_dev, b, cfg)  # warm-up
    for rep in range(DF64_WALL_REPS):
        for f in (list(cfgs) if rep % 2 == 0 else list(cfgs)[::-1]):
            t0 = time.perf_counter()
            solve(A_dev, b, cfgs[f])
            torch.cuda.synchronize()
            walls[f].append(time.perf_counter() - t0)
    med = {f: statistics.median(v) for f, v in walls.items()}
    log(f"solve walls df64 path (s, {DF64_WALL_REPS} each after a warm-up"
        f"{', interleaved' if DF64_WALL_REPS > 1 else ''}): "
        + "; ".join(f"{f} {walls_text(v)}" for f, v in walls.items()))
    log(f"df64/baseline wall ratio (CGSR): {med['df64 cgsr'] / med['baseline cgsr']:.4f}; "
        f"df64 icwy/sequential {med['df64 mgs icwy'] / med['df64 mgs sequential']:.4f}")
    return med


def nan_fallback_phase(torch):
    """The overflow matrix of tests/test_aux.py:65-85 (n = 32, diagonal
    3e38, CSR) in mixed with nan_fallback: the fp32 inner loop overflows,
    the solve is repeated in baseline on the card."""
    from gmres_tpu_torch import GmresConfig, PrecisionSpec, solve
    from gmres_tpu_torch.sparse import csr_from_coo

    n, big = 32, 3e38
    rows = np.arange(n)
    A = csr_from_coo(rows, rows, np.full(n, big), n_rows=n)
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"), precond="identity",
                      restart_length=5, tol=1e-10, max_restarts=50, nan_fallback=True,
                      auto_format=False)
    res = solve(A, np.ones(n), cfg)
    x = res.x.cpu().numpy()
    err = float(np.abs(x * big - 1.0).max())
    log(f"nan fallback: converged={res.converged} fellback_to_fp64={res.fellback_to_fp64} "
        f"restarts={res.restarts} x on {res.x.device}, max |x big - 1| = {err:.3e}")
    require(res.converged and res.fellback_to_fp64 and res.x.is_cuda,
            "nan fallback: converged in fp64 on the card")
    require(err <= cfg.tol * (1 + np.sqrt(n)), "nan fallback: x = 1/big to the tolerance")


def checkpoint_phase(torch, A, A_dev):
    """A mixed CGSR solve at convdiff@1M with CheckpointSpec(every=10) to a
    file under build/: aborted at max_restarts=12 (saved at 10), resumed to
    the uninterrupted solve's restarts, x within 1e-12 of it."""
    import tempfile

    from gmres_tpu_torch import rand_vect, solve
    from gmres_tpu_torch.ops.cuda._build import BUILD_ROOT
    from gmres_tpu_torch.utils.checkpoint import CheckpointSpec, load

    n = A.n_rows
    b = torch.tensor(-csr_residual(A, rand_vect(n, 42), np.zeros(n)), device="cuda")
    cfg = config("mixed", "identity")
    full = solve(A_dev, b, cfg)
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        ck = CheckpointSpec(path=os.path.join(tmp, "convdiff.ckpt"), every=10)
        part = solve(A_dev, b, cfg.with_(max_restarts=12), checkpoint=ck)
        saved = load(ck.path)
        res = solve(A_dev, b, cfg, checkpoint=ck)
    diff = float((res.x - full.x).norm() / full.x.norm())
    log(f"checkpoint: aborted={part.aborted} at {part.restarts}, file at restart {saved[1]} "
        f"({saved[2]} iterations); resumed {res.restarts}/{res.total_iters} against "
        f"{full.restarts}/{full.total_iters} uninterrupted, x rel diff {diff:.3e}")
    require(part.aborted and part.restarts == 12 and saved[1] == 10,
            "checkpoint: aborted at 12, file written at 10")
    require(res.converged and (res.restarts, res.total_iters) == (full.restarts,
                                                                  full.total_iters)
            and full.restarts == DF64_HISTORY[0] and diff <= 1e-12,
            "checkpoint: the resumed solve ends as the uninterrupted one")


def convdiff_df64_path(torch, record, A, A_dev):
    """The df64 tier at convdiff@1M on the staged DIA operator: kernel
    checks, CGSR, CGS and MGS (sequential and ICWY) solves with their launch
    counts, step and solve walls, then the NaN-fallback and checkpoint
    phases; returns the launch counts of the df64 solves."""
    from gmres_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    check_df64_kernels(torch, A, record)
    reset_launch_counts()
    for label, kw, converges in (("cgsr", {}, True), ("cgs", dict(orth="cgs"), True),
                                 ("mgs sequential", dict(orth="mgs", low_sync_mgs=False), True),
                                 ("mgs icwy", dict(orth="mgs", low_sync_mgs=True), True)):
        before = launch_counts()
        res, _ = solve_timed(torch, f"convdiff-df64 {label}", "df64", A, A_dev,
                             config("df64", "identity", **kw), 1, history=True,
                             converges=converges, warm_up=False)
        after = launch_counts()
        c = {k: after[k] - before[k] for k in after}
        log(f"  launches {label} df64: {c}")
        if label != "cgs":
            want = DF64_HISTORY
            log(f"  vs the reference's {want[0]}/{want[1]}: restarts "
                f"{res.restarts - want[0]:+d}")
            require(abs(res.restarts - want[0]) <= 1,
                    f"df64 {label}: {res.restarts}/{res.total_iters} not within one restart "
                    f"of {want[0]}/{want[1]}")
        require(c["dia_spmv_df64"] == res.total_iters and c["df_gram"] > 0
                and c["df_update_sumsq"] > 0 and c["dia_residual"] > 0
                and c["basis_axpy"] > 0,
                f"df64 {label}: K8 once a step, K9, K11, K1 residual and K4 pair launched ({c})")
        require((c["df_update_gram"] > 0) == (label == "cgsr"),
                f"df64 {label}: K10 in CGSR only ({c})")
        require(all(c[k] == 0 for k in DF64_IDLE + PATH_KERNELS["mesh3d"] + ILU_KERNELS),
                f"df64 {label}: no K1 plain mode, K2, K3, K2x2, K7, K5 nor K6 ({c})")
    counts = launch_counts()
    log(f"  launches convdiff-df64: {counts}")
    df64_step_walls(torch, A.n_rows)
    df64_solve_walls(torch, A, A_dev)
    nan_fallback_phase(torch)
    checkpoint_phase(torch, A, A_dev)
    return counts


def check_halo_kernels(torch, A_csr, record):
    """K12 against its plain versions at the row blocks of convdiff@1M over
    DIST_RANKS ranks (r = 262,144 rows, 5 bands, offsets +-1 and +-1024,
    edges of 1024 values): an interior block, the first (its left edge
    zeros) and the last (its right edge zeros); fp32 and fp64, and residual
    mode (fp64 operator, the norm of r demoted to fp32 or not).  One call:
    torch.mv of the block's rows, as a CSR tensor over the window [left | x |
    right], with that window.  At the interior block also halo_table.  The
    residual mode's device kernels a call are counted by one_kernel_checks."""
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk
    from gmres_tpu_torch.ops.dia import from_csr
    from gmres_tpu_torch.parallel.halo import HaloDIA, partition_halo

    H = partition_halo(A_csr, DIST_RANKS)
    r, hl, hr = H.rows_per_shard, H.halo_left, H.halo_right
    require(isinstance(H, HaloDIA) and (r, hl, hr) == (A_csr.n_rows // DIST_RANKS, NX, NX)
            and H.offsets == (-NX, -1, 0, 1, NX),
            f"convdiff@1M halo-partitions into {DIST_RANKS} DIA blocks with edges of {NX}")
    offs, D = H.offsets, len(H.offsets)
    rp, ci, v = A_csr.numpy_arrays()
    rng = np.random.default_rng(10)
    timer = Timer(torch)
    A262 = from_csr(convection_diffusion_2d(NX_262K, beta=2.0))
    for side, s in (("interior", 1), ("first", 0), ("last", DIST_RANKS - 1)):
        d64 = torch.tensor(H.data[s], device="cuda")
        x64 = torch.tensor(rng.random(r), device="cuda")
        l64 = torch.tensor(rng.random(hl) if s > 0 else np.zeros(hl), device="cuda")
        r64 = torch.tensor(rng.random(hr) if s < DIST_RANKS - 1 else np.zeros(hr), device="cuda")
        b64 = torch.tensor(rng.standard_normal(r), device="cuda")
        a, e = int(rp[s * r]), int(rp[(s + 1) * r])
        win = (torch.tensor((rp[s * r:(s + 1) * r + 1] - a).astype(np.int32), device="cuda"),
               torch.tensor((ci[a:e] - (s * r - hl)).astype(np.int32), device="cuda"),
               v[a:e])
        for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            key = dt_name if side == "interior" else f"{dt_name} {side}"
            sz = dt.itemsize
            data, x, left, right = (t.to(dt) for t in (d64, x64, l64, r64))
            got = hk.dia_spmv_halo_cuda(data, offs, x, left, right)
            want = hk.dia_spmv_halo_plain(data, offs, x, left, right)
            scale = hk.dia_spmv_halo_plain(data.abs(), offs, x, left, right)
            W = torch.sparse_csr_tensor(win[0], win[1], torch.tensor(win[2], dtype=dt,
                                                                     device="cuda"),
                                        size=(r, hl + r + hr))
            xx = torch.cat([left, x, right])
            record("dia_spmv_halo", dt_name, *compare(dt_name, [got], [want], [scale]),
                   timer(lambda: hk.dia_spmv_halo_cuda(data, offs, x, left, right)),
                   timer(lambda: hk.dia_spmv_halo_plain(data, offs, x, left, right)),
                   (D + 2) * r * sz + (hl + hr) * sz, 2 * D * r,
                   timer(lambda: torch.mv(W, xx)), key=key)
            if side == "interior":
                halo_table(torch, timer, dt, data, offs, x, left, right, A262, record.copy_gbs)
            check_residual(torch, record, "dia_residual_halo", dt, dt_name, timer,
                           lambda: hk.dia_residual_halo_cuda(d64, offs, b64, x64, l64, r64, dt),
                           lambda: hk.dia_residual_halo_plain(d64, offs, b64, x64, l64, r64, dt),
                           b64.abs() + hk.dia_spmv_halo_plain(d64.abs(), offs, x64, l64, r64),
                           (D + 3) * r * 8 + (hl + hr) * 8, (2 * D + 5) * r, key=key)
            del W, xx
        torch.cuda.synchronize()
        del d64, x64, l64, r64, b64
    record.require_ok()


def dist_rank(cases, argv):
    """One rank of the convdiff-dist path, in a spawned process sharing the
    card: the distributed dryrun, every case (``run_cases``), then
    ``cli.solve.main(argv)`` with its standard output captured; returns the
    cases' results, the command's exit code, output, seconds and launches,
    and the launch counts of this rank's solves."""
    import contextlib
    import io

    from gmres_tpu_torch.cli import solve as cli
    from gmres_tpu_torch.ops.cuda import form_launch_counts, launch_counts
    from gmres_tpu_torch.parallel.dist_gmres import dryrun_on_rank, run_cases

    before, forms_before = launch_counts(), form_launch_counts()
    t0 = time.perf_counter()
    dry = dryrun_on_rank("cuda")
    dry_seconds = time.perf_counter() - t0
    results = run_cases(cases, "cuda")
    cli_before = launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    cli_seconds = time.perf_counter() - t0
    after, forms_after = launch_counts(), form_launch_counts()
    forms = {k: {f: n - forms_before[k].get(f, 0) for f, n in v.items()}
             for k, v in forms_after.items()}
    return dict(dryrun=dry, dryrun_seconds=dry_seconds, results=results,
                cli=(rc, buf.getvalue(), cli_seconds,
                     {k: after[k] - cli_before[k] for k in after}),
                launches={k: after[k] - before[k] for k in after}, forms=forms)


def dist_tier_config(tier, precond="identity", **kw):
    """The distributed path's precision tiers: "mixed-cb" (a bf16 basis),
    "baseline-cb" (an fp32 one), "df64", "bf16" (the bf16 inner tier with a
    bf16 M)."""
    from gmres_tpu_torch import PrecisionSpec

    if tier.endswith("-cb"):
        mode = tier[:-3]
        return cb_config(mode, "bfloat16" if mode == "mixed" else "float32", **kw).with_(
            precond=precond)
    if tier == "bf16":
        return config("mixed", precond, **kw).with_(
            precision=PrecisionSpec("float64", "bfloat16", "bfloat16"))
    return config(tier, precond, **kw)


def check_sell_rank_kernels(torch, mesh, record):
    """K5's rank form (residual mode on a rank's SELL block: b and r the
    block's rows, x gathered, ||x||^2 over the rank's rows) against its plain
    twin at the blocks of mesh3d@1M over DIST_RANKS ranks on the SELL grid,
    the first and the last block, fp64 operator with the norm in fp32 and in
    fp64.  Its bytes: each slot's value and column, the block's b and r and
    the distinct entries of x its columns reach."""
    from gmres_tpu_torch.ops.cuda import sell_kernel as sl
    from gmres_tpu_torch.ops.sell import sell_from_csr
    from gmres_tpu_torch.parallel.dist_gmres import sell_rows_per
    from gmres_tpu_torch.sparse import csr_from_arrays

    n = mesh.n_rows
    r = sell_rows_per(n, DIST_RANKS)
    rp, ci, v = mesh.numpy_arrays()
    rng = np.random.default_rng(14)
    timer = Timer(torch)
    x64 = torch.tensor(rng.random(r * DIST_RANKS), device="cuda")
    for side, rank in (("first", 0), ("last", DIST_RANKS - 1)):
        lo, hi = min(rank * r, n), min((rank + 1) * r, n)
        rows = np.full(r + 1, rp[hi] - rp[lo])
        rows[:hi - lo + 1] = rp[lo:hi + 1] - rp[lo]
        S = sell_from_csr(csr_from_arrays(rows, ci[rp[lo]:rp[hi]], v[rp[lo]:rp[hi]],
                                          n_cols=r * DIST_RANKS), float("inf")).to("cuda")
        b64 = torch.tensor(rng.standard_normal(r), device="cuda")
        reach = int(torch.unique(S.cols).numel())
        args = (S.vals, S.cols, S.slice_ptr, b64, x64)
        for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            check_residual(torch, record, "sell_residual", dt, dt_name, timer,
                           lambda: sl.sell_residual_cuda(*args, dt, x_off=rank * r),
                           lambda: sl.sell_residual_plain(*args, dt, x_off=rank * r),
                           b64.abs() + sl.sell_spmv_plain(S.vals.abs(), S.cols, S.slice_ptr,
                                                          x64, r),
                           S.n_slots * 12 + 2 * r * 8 + reach * 8, 2 * S.n_slots + 5 * r,
                           key=f"{dt_name} rank {side}")
        torch.cuda.synchronize()
        del S, b64
    record.require_ok()


def dist_case_kernels(case):
    """(must launch, must not launch) for one distributed case on its ranks:
    the per-rank SELL route K5 in both modes (its residual in the rank form)
    and no K12 or K1; a block-Jacobi ILU K1 (its DIA factor sweeps) beside
    K12; any other case K12 (the plain mode unless its operator is bf16) and
    no K1 or K5; no case K1's residual mode, K6, K7 or K8 (DIST_NEVER)."""
    if case.get("kind") == "sell":
        return {"sell_spmv", "sell_residual"}, set(DIST_KERNELS) | {"dia_spmv", *DIST_NEVER}
    halo = {"dia_residual_halo"}
    if not case["label"].startswith("tier bf16"):
        halo.add("dia_spmv_halo")
    if case["cfg"].precond.value == "bilu_jacobi":
        return halo | {"dia_spmv"}, {"sell_spmv", "sell_residual", *DIST_NEVER}
    return halo, {"dia_spmv", "sell_spmv", "sell_residual", *DIST_NEVER}


def convdiff_dist_path(torch, record, A, A_dev, x_single, walls_single, mesh, mesh_x):
    """The distributed path: K12 checked at the row blocks of convdiff@1M
    and K5's rank form at those of mesh3d@1M, then DIST_RANKS gloo ranks on
    this card run the dryrun, CGSR in both modes (the reference's 26/780, x
    against the single-card solve of the first path), mixed MGS under the
    low_sync_mgs=None rule (26/780), MGS sequential and ICWY after a warm-up
    of each, cut at DIST_MGS_RESTARTS restarts (the evidence for that rule
    on CUDA), and
    ILU-Jacobi(3) mixed at convdiff(512); then the precision tiers: mixed-cb
    and baseline-cb CGSR (CB_RESTARTS; mixed-cb's cycles and x against a
    single-card solve), df64 CGSR (the reference's 26/780, x against a
    single-card solve), df64 MGS ICWY and sequential cut at
    DIST_MGS_RESTARTS, and the bf16 tier with Jacobi and with a bf16
    ILU-Jacobi(3) at convdiff(512), cut at DIST_BF16_RESTARTS (no
    escalation), its backward error per cycle beside the single card's bf16
    phase; then the block-Jacobi ILU(3) CGSR in both modes at 1M
    (BILU_RESTARTS) and at convdiff(512) (the JAX package's CPU counts,
    BILU_CPU), the per-rank SELL route on mesh3d@1M (1/30, x against the
    single card's, DIST_SELL_X_DIFF), the checkpointed mixed CGSR solve cut
    at DIST_CKPT_CUT and resumed (26/780, x the uninterrupted solve's bits),
    df64 the same cut short (DIST_CKPT_DF64), and mixed CGSR with
    ``multihost=True`` (the default's bits from a quarter of the partition's
    bytes, cut at DIST_CKPT_CUT); then per-host input: convdiff@1M written to
    the cli phase's ``.mtx`` here (``mmio.write_coordinate``), each rank
    loading its own rows (``load_matrix_rows`` of ``process_row_range(...,
    fmt='auto')``) and solving mixed CGSR with identity and with the
    block-Jacobi ILU(3), the whole-matrix solves' counts and x bit for bit;
    last ``cli.solve.main(["--dist", ...])`` on the ranks at that file (only
    rank 0 prints; its block is held to the single-device command's in the
    cli phase).  Each case's launches are held to ``dist_case_kernels``, the
    command line's to K12 alone.  Returns the ranks' summed launch counts,
    their summed form counts, and for the cli phase the file's directory,
    path, write seconds and each rank's command-line (exit code, output,
    seconds, launches)."""
    import shutil
    import tempfile

    from gmres_tpu_torch.io import mmio

    cli_tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        a_path = os.path.join(cli_tmp, "convdiff_1m.mtx")
        t0 = time.perf_counter()
        mmio.write_coordinate(a_path, A.n_rows, A.n_cols, A.row_ids.numpy(), A.col_idx.numpy(),
                              A.vals.numpy())
        write_seconds = time.perf_counter() - t0
        return (*dist_cases(torch, record, A, A_dev, x_single, walls_single, mesh, mesh_x,
                            a_path), cli_tmp, a_path, write_seconds)
    except BaseException:
        shutil.rmtree(cli_tmp, ignore_errors=True)
        raise


def dist_cases(torch, record, A, A_dev, x_single, walls_single, mesh, mesh_x, a_path):
    """The body of ``convdiff_dist_path``: returns the ranks' summed launch
    and form counts and rank by rank their command-line results."""
    import shutil
    import tempfile

    from gmres_tpu_torch import rand_vect, solve
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.parallel import launch
    from gmres_tpu_torch.utils.checkpoint import CheckpointSpec

    check_halo_kernels(torch, A, record)
    check_sell_rank_kernels(torch, mesh, record)
    A512 = convection_diffusion_2d(NX_262K, beta=2.0)
    b, b512, b_mesh = (-csr_residual(M, rand_vect(M.n_rows, 42), np.zeros(M.n_rows))
                       for M in (A, A512, mesh))
    # the single card's solves the tiers are held to, run here before the ranks
    t0 = time.perf_counter()
    A512_dev = stage_timed(torch, A512)[0]
    single = {}
    for tier, A_csr, A_op, bb, cfg in (
            ("mixed-cb", A, A_dev, b, dist_tier_config("mixed-cb")),
            ("df64", A, A_dev, b, dist_tier_config("df64")),
            ("bf16 jacobi", A512, A512_dev, b512,
             dist_tier_config("bf16", "jacobi", max_restarts=DIST_BF16_RESTARTS,
                              jacobi_steps=3)),
            # M is built from the CSR matrix, which solve stages itself
            ("bf16 ilu_jacobi(3)", A512, A512, b512,
             dist_tier_config("bf16", "ilu_jacobi", jacobi_steps=3,
                              max_restarts=DIST_BF16_RESTARTS))):
        res = solve(A_op, torch.tensor(bb, device="cuda"), cfg, record_history=True)
        single[tier] = res
        log(f"  single card {tier}: converged={res.converged} escalated={res.escalated} "
            f"{res.restarts}/{res.total_iters}")
    log(f"  the single card's tier solves: {time.perf_counter() - t0:.1f} s")
    cases = [dict(label=f"cgsr {mode}", A=A, b=b, cfg=config(mode, "identity"))
             for mode in ("baseline", "mixed")]
    cases.append(dict(label="mgs default mixed", A=A, b=b,
                      cfg=config("mixed", "identity", orth="mgs")))
    cases += [dict(label=f"mgs {form} mixed warm-up", warm_up=True, A=A, b=b,
                   cfg=config("mixed", "identity", orth="mgs", low_sync_mgs=form == "icwy")
                   .with_(max_restarts=1)) for form in ("sequential", "icwy")]
    for rep in range(DIST_MGS_REPS):
        forms = ("sequential", "icwy") if rep % 2 == 0 else ("icwy", "sequential")
        cases += [dict(label=f"mgs {form} mixed cut", A=A, b=b,
                       cfg=config("mixed", "identity", orth="mgs", low_sync_mgs=form == "icwy")
                       .with_(max_restarts=DIST_MGS_RESTARTS)) for form in forms]
    cases.append(dict(label="ilu_jacobi(3) mixed 262K", A=A512, b=b512,
                      cfg=config("mixed", "ilu_jacobi", jacobi_steps=3)))
    tier_cases = [dict(label="tier mixed-cb cgsr", A=A, b=b, history=True,
                       cfg=dist_tier_config("mixed-cb")),
                  dict(label="tier baseline-cb cgsr", A=A, b=b,
                       cfg=dist_tier_config("baseline-cb")),
                  dict(label="tier df64 cgsr", A=A, b=b, cfg=dist_tier_config("df64"))]
    tier_cases += [dict(label=f"tier df64 mgs {form} cut", A=A, b=b,
                        cfg=dist_tier_config("df64", orth="mgs", low_sync_mgs=form == "icwy",
                                             max_restarts=DIST_MGS_RESTARTS))
                   for form in ("icwy", "sequential")]
    # MGS under low_sync_mgs=None: ICWY in every tier on CUDA (K2x2's forms)
    tier_cases += [dict(label=f"tier {tier} mgs icwy cut", A=A, b=b,
                        cfg=dist_tier_config(tier, orth="mgs", max_restarts=DIST_MGS_RESTARTS))
                   for tier in ("mixed-cb", "baseline-cb")]
    tier_cases += [dict(label=f"tier bf16 {name} cut", A=A512, b=b512, history=True,
                        cfg=dist_tier_config("bf16", precond, max_restarts=DIST_BF16_RESTARTS,
                                             jacobi_steps=3))
                   for name, precond in (("jacobi", "jacobi"), ("ilu_jacobi(3)", "ilu_jacobi"))]
    cases += tier_cases
    # the block-Jacobi ILU, the per-rank SELL route, the sharded
    # checkpoint and per-host partitioning
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    spec = CheckpointSpec(os.path.join(ckpt_dir, "mixed"), every=DIST_CKPT_EVERY)
    spec64 = CheckpointSpec(os.path.join(ckpt_dir, "df64"), every=DIST_CKPT_DF64[0])
    for mode in ("baseline", "mixed"):
        cases += [dict(label=f"bilu_jacobi(3) {mode}", kind="bilu", A=A, b=b,
                       cfg=config(mode, "bilu_jacobi", jacobi_steps=3, max_restarts=200)),
                  dict(label=f"bilu_jacobi(3) {mode} 262K", kind="bilu262", A=A512, b=b512,
                       history=True,
                       cfg=config(mode, "bilu_jacobi", jacobi_steps=3, max_restarts=200))]
    cases += [
        dict(label="sell mesh3d mixed", kind="sell", synth=MESH3D_SPEC, b=b_mesh,
             cfg=config("mixed", "identity")),
        dict(label="ckpt mixed cut", kind="ckpt-cut", A=A, b=b, checkpoint=spec,
             cfg=config("mixed", "identity", max_restarts=DIST_CKPT_CUT)),
        dict(label="ckpt mixed resume", kind="ckpt-resume", A=A, b=b, checkpoint=spec,
             cfg=config("mixed", "identity")),
        dict(label="ckpt df64 cut", kind="ckpt-cut", A=A, b=b, checkpoint=spec64,
             cfg=dist_tier_config("df64", max_restarts=DIST_CKPT_DF64[0])),
        dict(label="ckpt df64 resume", kind="ckpt-resume", A=A, b=b, checkpoint=spec64,
             cfg=dist_tier_config("df64", max_restarts=DIST_CKPT_DF64[1])),
        dict(label="df64 cut", kind="df64-cut", A=A, b=b,
             cfg=dist_tier_config("df64", max_restarts=DIST_CKPT_DF64[1])),
        dict(label="ckpt mixed cut multihost", kind="multihost", A=A, b=b, multihost=True,
             cfg=config("mixed", "identity", max_restarts=DIST_CKPT_CUT)),
        dict(label="rows cgsr mixed", kind="rows", mtx=a_path, b=b,
             cfg=config("mixed", "identity")),
        dict(label="rows bilu_jacobi(3) mixed", kind="rows", mtx=a_path, b=b,
             cfg=config("mixed", "bilu_jacobi", jacobi_steps=3, max_restarts=200))]
    t0 = time.perf_counter()
    try:
        ranks = launch.spawn(dist_rank, DIST_RANKS, args=(cases, ["--dist", *CLI_DIST_ARGV,
                                                                   "--Apath", a_path]),
                             timeout=DIST_TIMEOUT, threads=2)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"convdiff-dist: {DIST_RANKS} gloo ranks on one card, {len(cases)} solves and the "
        f"--dist command line, {time.perf_counter() - t0:.1f} s from spawn to the last rank's "
        f"result")
    log(f"  dryrun (poisson_2d(10), mixed ILU-Jacobi(2)) per rank: "
        f"{[r['dryrun'] for r in ranks]}, {max(r['dryrun_seconds'] for r in ranks):.2f} s")
    walls, got = {}, {}
    for i, case in enumerate(cases):
        res = [r["results"][i] for r in ranks]
        first = got[case["label"]] = res[0]
        require(all((q["restarts"], q["total_iters"]) == (first["restarts"], first["total_iters"])
                    and np.array_equal(q["x"], first["x"]) for q in res[1:]),
                f"dist {case['label']}: every rank holds the same result")
        M = mesh if case.get("kind") == "sell" else case.get("A", A)
        x = first["x"]
        backward = float(np.linalg.norm(csr_residual(M, x, case["b"]))
                         / (np.linalg.norm(case["b"])
                            + np.linalg.norm(M.vals.numpy()) * np.linalg.norm(x)))
        wall = max(q["seconds"] for q in res)
        walls.setdefault(case["label"], []).append(wall)
        log(f"solve dist {case['label']}: converged={first['converged']} "
            f"restarts={first['restarts']} total_iters={first['total_iters']} wall {wall:.4f} s "
            f"(ranks {[round(q['seconds'], 4) for q in res]}) backward_err={backward:.3e} "
            f"setup {max(q['setup_seconds'] for q in res):.3f} s, partition bytes a rank "
            f"{[q['partition_local_bytes'] for q in res]}")
        require(x.shape == (M.n_rows,) and np.all(np.isfinite(x)),
                f"dist {case['label']}: x finite, shape ({M.n_rows},)")
        on, off = dist_case_kernels(case)
        for r, q in enumerate(res):
            c = q["launches"]
            require(all(c[k] > 0 for k in on) and all(c[k] == 0 for k in off),
                    f"dist {case['label']} rank {r}: launched {sorted(on)}, none of "
                    f"{sorted(off)} ({ {k: v for k, v in c.items() if v} })")
        if case.get("warm_up"):
            require(first["aborted"] and first["restarts"] == 1,
                    f"dist {case['label']}: cut at 1 restart")
            continue
        if case.get("kind"):
            dist_new_checks(case, first, backward, got, x_single, mesh_x)
            continue
        if case["label"].startswith("tier "):
            dist_tier_checks(case, first, backward, single)
            continue
        if case["label"].endswith("cut"):
            require(first["aborted"] and first["restarts"] == DIST_MGS_RESTARTS,
                    f"dist {case['label']}: cut at {DIST_MGS_RESTARTS} restarts")
            continue
        require(first["converged"] and backward <= 1e-8,
                f"dist {case['label']}: converged, backward error {backward:.3e} <= 1e-8")
        if M is A:
            want = MGS_HISTORY if case["label"].startswith("mgs") else (26, TPU_ITERS)
            require(abs(first["restarts"] - want[0]) <= 1,
                    f"dist {case['label']}: {first['restarts']}/{first['total_iters']} not "
                    f"within one restart of {want[0]}/{want[1]}")
        if case["label"].startswith("cgsr"):
            mode = case["label"].split()[1]
            diff = float(np.linalg.norm(x - x_single[mode]) / np.linalg.norm(x_single[mode]))
            log(f"  x against the single-card solve ({mode}): rel diff {diff:.3e}")
            require(diff <= 1e-6, f"dist cgsr {mode}: x within 1e-6 of the single-card x "
                                  f"({diff:.3e})")
    for r, rank in enumerate(ranks):
        rc, out, seconds, c = rank["cli"]
        log(f"  cli solve --dist rank {r}: exit code {rc}, {seconds:.1f} s, launches "
            f"{ {k: v for k, v in c.items() if v} }")
        require(rc == 0 and (r == 0 or out == "")
                and all(c[k] > 0 for k in DIST_KERNELS)
                and all(c[k] == 0 for k in ("dia_spmv", "sell_spmv", "sell_residual",
                                            *DIST_NEVER)),
                f"cli solve --dist rank {r}: exit 0, no output but on rank 0, K12 in both modes "
                f"and no K1, K5, K6, K7 or K8 ({c})")
        c = rank["launches"]
        log(f"  launches convdiff-dist rank {r}: {c}")
        require(all(c[k] > 0 for k in DIST_KERNELS + DF64_KERNELS[1:])
                and all(c[k] == 0 for k in DIST_NEVER),
                f"dist rank {r}: K12 both modes and K9-K11 launched; no K1 residual, K6, K7, "
                f"K8 ({c})")
        forms = rank["forms"]
        log(f"  form launches convdiff-dist rank {r}: {forms}")
        require(all(forms[k].get(f, 0) > 0 for k, want in DIST_FORMS.items() for f in want)
                and forms["sell_residual"].get("f64_rank", 0) > 0,
                f"dist rank {r}: every tier's dtype forms and K5's rank form launched "
                f"{DIST_FORMS} ({forms})")
    for mode in ("baseline", "mixed"):
        log(f"dist wall {mode} cgsr {walls[f'cgsr {mode}'][0]:.4f} s against the single "
            f"card's {walls_single[mode]:.4f} s (ratio "
            f"{walls[f'cgsr {mode}'][0] / walls_single[mode]:.4f})")
    steps = DIST_MGS_RESTARTS * RLEN
    med = {f: statistics.median(walls[f"mgs {f} mixed cut"]) for f in ("sequential", "icwy")}
    log(f"dist mgs mixed, {DIST_MGS_REPS} solves of {steps} steps each after a warm-up"
        f"{', interleaved' if DIST_MGS_REPS > 1 else ''} (s): "
        + "; ".join(f"{f} {walls_text(walls[f'mgs {f} mixed cut'])}"
                    f" ({1e3 * med[f] / steps:.2f} ms a step)" for f in med)
        + f"; icwy/sequential {med['icwy'] / med['sequential']:.4f}")
    counts = {k: sum(rank["launches"][k] for rank in ranks) for k in ranks[0]["launches"]}
    forms = Counter()
    for rank in ranks:
        for k, v in rank["forms"].items():
            forms.update({(k, f): n for f, n in v.items()})
    return counts, forms, [rank["cli"] for rank in ranks]


def dist_new_checks(case, got, backward, results, x_single, mesh_x):
    """The checks of the distributed cases with a ``kind``: the block-Jacobi
    ILU at 1M in BILU_RESTARTS and at convdiff(512) held to the JAX
    package's CPU counts and cycles, each converged; the SELL route's 1/30
    and x within DIST_SELL_X_DIFF of the single card's; a checkpointed
    solve's cut and its resume equal, bit for bit, to the uninterrupted
    solve (26/780 in mixed; df64 the solve cut at DIST_CKPT_DF64[1]);
    ``multihost=True`` and per-host rows the whole-matrix solve's bits from
    about a quarter of its partition bytes."""
    label, kind = case["label"], case["kind"]
    rel = lambda a, c: float(np.linalg.norm(a - c) / np.linalg.norm(c))
    if kind in ("bilu", "bilu262"):
        require(got["converged"] and backward <= 1e-8,
                f"dist {label}: converged, backward error {backward:.3e} <= 1e-8")
        mode = label.split()[1]
        if kind == "bilu":
            lo, hi = BILU_RESTARTS
        else:
            want = BILU_CPU[mode][0]
            lo, hi = want - BILU_SLACK, want + (BILU_MIXED_SLACK if mode == "mixed"
                                                else BILU_SLACK)
            history = [h["rel_initial"] for h in got["history"]]
            ratios = [c / w for c, w in zip(history[1:BILU_CYCLES + 1], BILU_CPU_CYCLES[mode])]
            log(f"  {label}: {got['restarts']}/{got['total_iters']}, the JAX package's on the "
                f"CPU {want}/{BILU_CPU[mode][1]}; backward error per cycle "
                f"{', '.join(f'{c:.4e}' for c in history)}; cycles "
                f"1-{BILU_CYCLES} over the JAX package's {min(ratios):.6f}..{max(ratios):.6f}")
            require(len(ratios) == BILU_CYCLES
                    and all(abs(q - 1) <= BILU_CYCLE_REL[mode] for q in ratios),
                    f"dist {label}: cycles 1-{BILU_CYCLES} within {BILU_CYCLE_REL[mode]:g} of "
                    f"the JAX package's ({min(ratios):.6f}..{max(ratios):.6f})")
        require(lo <= got["restarts"] <= hi,
                f"dist {label}: {got['restarts']}/{got['total_iters']} restarts not in {lo}..{hi}")
    elif kind == "sell":
        diff = rel(got["x"], mesh_x)
        log(f"  {label}: x against the single card's mesh3d mixed x: rel diff {diff:.3e}")
        require(got["converged"] and backward <= 1e-8
                and (got["restarts"], got["total_iters"]) == MESH_TPU_HISTORY
                and diff <= DIST_SELL_X_DIFF,
                f"dist {label}: {got['restarts']}/{got['total_iters']} (the TPU's "
                f"{MESH_TPU_HISTORY}), backward error {backward:.3e}, x within "
                f"{DIST_SELL_X_DIFF:g} of the single card's ({diff:.3e})")
    elif kind == "ckpt-cut":
        want = case["cfg"].max_restarts
        require(got["aborted"] and got["restarts"] == want, f"dist {label}: cut at {want}")
    elif kind == "ckpt-resume":
        if "df64" in label:  # held at "df64 cut", which runs after it
            return
        ref = results["cgsr mixed"]
        require(got["converged"] and abs(got["restarts"] - 26) <= 1
                and (got["restarts"], got["total_iters"]) == (ref["restarts"], ref["total_iters"])
                and np.array_equal(got["x"], ref["x"]),
                f"dist {label}: {got['restarts']}/{got['total_iters']}, the uninterrupted "
                f"solve's {ref['restarts']}/{ref['total_iters']} and x bit for bit")
    elif kind == "df64-cut":
        res = results["ckpt df64 resume"]
        require(got["aborted"] and got["restarts"] == DIST_CKPT_DF64[1]
                and (res["restarts"], res["total_iters"]) == (got["restarts"],
                                                             got["total_iters"])
                and np.array_equal(res["x"], got["x"]),
                f"dist {label}: the resumed df64 solve equals the uninterrupted one, bit for "
                f"bit ({res['restarts']}/{res['total_iters']} vs "
                f"{got['restarts']}/{got['total_iters']})")
    elif kind in ("multihost", "rows"):
        # against the same solve on the whole matrix without per-host
        # partitioning (the cut of the checkpointed solve is that solve's
        # first DIST_CKPT_CUT restarts)
        ref = results[{"multihost": "ckpt mixed cut"}.get(kind, label[len("rows "):])]
        whole = results[label[len("rows "):]] if kind == "rows" else results["cgsr mixed"]
        share = got["partition_local_bytes"] / whole["partition_local_bytes"]
        log(f"  {label}: partition bytes a rank {got['partition_local_bytes']:,} against the "
            f"whole matrix's {whole['partition_local_bytes']:,} ({share:.4f}); setup "
            f"{got['setup_seconds']:.3f} s against {whole['setup_seconds']:.3f} s"
            + (f"; load_matrix_rows {got['load_seconds']:.3f} s" if kind == "rows" else ""))
        require((got["restarts"], got["total_iters"]) == (ref["restarts"], ref["total_iters"])
                and np.array_equal(got["x"], ref["x"]) and share <= 0.3,
                f"dist {label}: the whole-matrix solve's {ref['restarts']}/{ref['total_iters']} "
                f"and x bit for bit from about a quarter of its bytes ({share:.4f})")


def dist_tier_checks(case, got, backward, single):
    """A precision tier's distributed solve against its bounds: mixed-cb and
    baseline-cb in CB_RESTARTS and df64 within one restart of 26/780, each
    converged (backward error <= 1e-8); mixed-cb's backward error per cycle
    within DIST_CB_CYCLE of the single card's and its x within
    DIST_CB_X_DIFF of the single card's x, df64's x within 1e-6 of its; the
    cut solves cut at their count, the bf16 ones neither stalled nor
    escalated (no stall window on the distributed path), their backward
    error per cycle within DIST_BF16_CYCLE of the single card's above the
    bf16 floor, the best within DIST_BF16_FLOOR of its best."""
    label = case["label"]

    def cycles(ref):
        mine = [h["rel_initial"] for h in got["history"]]
        theirs = [h["rel_initial"] for h in ref.history if "rel_initial" in h]
        log(f"  {label} backward error per cycle: {', '.join(f'{v:.3e}' for v in mine)}; the "
            f"single card's ({ref.restarts}/{ref.total_iters}, escalated={ref.escalated}): "
            f"{', '.join(f'{v:.3e}' for v in theirs)}")
        return mine, theirs

    if label.endswith("cut"):
        want = DIST_BF16_RESTARTS if "bf16" in label else DIST_MGS_RESTARTS
        require(got["aborted"] and got["restarts"] == want,
                f"dist {label}: cut at {want} restarts")
        if "bf16" not in label:
            return
        require(not got["stalled"] and not got["escalated"],
                f"dist {label}: no stall, no escalation on the distributed path")
        mine, theirs = cycles(single[label[len("tier "):-len(" cut")]])
        # above the bf16 floor the cycles follow the single card's; at it
        # (~1e-6) they scatter, and both reach it
        above = [m / t for m, t in zip(mine, theirs) if t > 10 * CB_BF16_BEST]
        floor = min(mine) / min(theirs)
        log(f"  {label}: above the floor, distributed over single card "
            f"{', '.join(f'{r:.4f}' for r in above)}; bests {floor:.4f}")
        require(len(mine) == len(theirs)
                and all(1 / DIST_BF16_CYCLE <= r <= DIST_BF16_CYCLE for r in above)
                and 1 / DIST_BF16_FLOOR <= floor <= DIST_BF16_FLOOR,
                f"dist {label}: cycles above the bf16 floor within {DIST_BF16_CYCLE}x of the "
                f"single card's, the best within {DIST_BF16_FLOOR}x ({floor:.3f})")
        return
    tier = label.split()[1]
    require(got["converged"] and backward <= 1e-8,
            f"dist {label}: converged, backward error {backward:.3e} <= 1e-8")
    lo, hi = CB_RESTARTS.get(tier, (DF64_HISTORY[0] - 1, DF64_HISTORY[0] + 1))
    require(lo <= got["restarts"] <= hi,
            f"dist {label}: {got['restarts']}/{got['total_iters']} restarts not in {lo}..{hi}")
    if tier not in single:
        return
    if tier == "mixed-cb":
        mine, theirs = cycles(single[tier])
        ratios = [m / t for m, t in zip(mine, theirs)]
        log(f"  {label}: distributed over single card per cycle "
            f"{min(ratios):.4f}..{max(ratios):.4f}")
        require(all(1 / DIST_CB_CYCLE <= r <= DIST_CB_CYCLE for r in ratios),
                f"dist {label}: each cycle's backward error within {DIST_CB_CYCLE}x of the "
                f"single card's ({min(ratios):.4f}..{max(ratios):.4f})")
    # convdiff@1M is ill-conditioned (x_true's relative error is ~0.67 at a
    # backward error of 1e-8): a bf16 basis summed per rank moves x by
    # up to DIST_CB_X_DIFF; df64's fp64-quality sums keep it within 1e-6,
    # as fp64's do
    xs = single[tier].x.cpu().numpy()
    diff = float(np.linalg.norm(got["x"] - xs) / np.linalg.norm(xs))
    bound = 1e-6 if tier == "df64" else DIST_CB_X_DIFF
    log(f"  x against the single-card solve ({tier}, {single[tier].restarts}/"
        f"{single[tier].total_iters}): rel diff {diff:.3e}")
    require(diff <= bound, f"dist {label}: x within {bound:.0e} of the single card's "
                           f"({diff:.3e})")


def cb_config(mode, basis, **kw):
    """config(mode, "identity", **kw) with the basis stored in `basis`."""
    import dataclasses

    cfg = config(mode, "identity", **kw)
    return cfg.with_(precision=dataclasses.replace(cfg.precision, basis=basis))


def bf16_config(outer="float64", precond="float32", **kw):
    """The bf16 inner tier: bf16 inner loop, `precond` preconditioner dtype."""
    from gmres_tpu_torch import PrecisionSpec

    return config("mixed", "identity", **kw).with_(
        precision=PrecisionSpec(outer, "bfloat16", precond))


def cb_forms():
    """The dtype forms that only the compressed-basis and bf16 tiers launch:
    those of _build's tables less the native ones (a sweep over an f32 or
    f64 basis with vectors of its dtype, K4 over an f32 or f64 basis with
    coefficients of its dtype).  Returns the sweeps' forms, (suffix, basis
    dtype, vector dtype), K4's, (suffix, basis, coefficients, iterate), and
    {kernel: the forms it must launch on the path}."""
    from gmres_tpu_torch.ops.cuda._build import AXPY_FORMS, GRAM2_FORMS, SWEEP_FORMS

    def name(dt):
        return str(dt).removeprefix("torch.")

    def native(v, w):
        return v == w and v.is_floating_point and v.itemsize >= 4

    sweeps = [(sfx, name(v), name(w)) for (v, w), sfx in SWEEP_FORMS.items()
              if not native(v, w)]
    axpys = [(sfx, name(v), name(y), name(x)) for (v, y, x), sfx in AXPY_FORMS.items()
             if not native(v, y)]
    path = {k: {f[0] for f in sweeps} for k in ("basis_gram", "basis_update_gram",
                                                "basis_update_sumsq", "basis_update",
                                                "basis_mgs")}
    path["basis_gram2"] = {sfx for (v, w), sfx in GRAM2_FORMS.items() if not native(v, w)}
    path["basis_axpy"] = {f[0] for f in axpys}
    return sweeps, axpys, path


def form_bound(torch, acc_name, scale, of=None, ulps=1.0):
    """The elementwise tolerance of a form's output against its plain
    version: TOL_REL of the accumulation dtype times the largest magnitude of
    `scale` (the two sum in another order) and, for an output rounded to
    bf16, `ulps` bf16 ulps of `of` (the plain output, or a bound on every
    value the element takes)."""
    bound = TOL_REL[acc_name] * float(scale.double().abs().max())
    if of is None:
        return torch.full((), bound, dtype=torch.float64, device=scale.device)
    return bound + ulps * BF16_ULP * of.double().abs()


def check_cb_kernels(torch, n, record):
    """The dtype forms of K2, K3 GRAM, K3 SUMSQ, K3 plain, K2x2 and K7 at
    convdiff@1M's shapes (a 31-row basis of N(0, 1/n) entries, at rows 31
    and 16, and an Arnoldi step's w = V^T c + e, u = c), and K4's forms (30
    rows), against their plain versions, each output elementwise within
    form_bound, with their bytes bound; no single PyTorch call takes a
    narrower basis than its vectors, so none is timed."""
    from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_
    from gmres_tpu_torch.ops.cuda import outer_kernel as ou
    from gmres_tpu_torch.ops.cuda._build import acc_dtype

    sweeps, axpys, path = cb_forms()
    timer = Timer(torch)
    m1 = RLEN + 1
    rng = np.random.default_rng(17)
    V64 = rng.standard_normal((m1, n)) / np.sqrt(n)
    c64 = rng.standard_normal(m1)
    w64 = V64.T @ c64 + CB_NOISE * np.sqrt(m1 / n) * rng.standard_normal(n)
    x64 = rng.standard_normal(n)

    def rec(kname, key, acc_name, outs, cuda, plain, nbytes, flops, plain_reps=REPS,
            timed=None):
        """outs: (dtype name, bound) of each output, the bound elementwise
        (form_bound); reports the largest error and the bound of the element
        nearest its own.  timed: the (kernel, plain) calls to time, where
        they differ from the compared ones (an update in place)."""
        got, want = cuda(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst, ok = None, True
        for g, w_, (dname, bound) in zip(got, want, outs):
            require(g.dtype == w_.dtype == getattr(torch, dname),
                    f"{kname} {key}: output dtype {g.dtype}, plain {w_.dtype}, want {dname}")
            err = (g.double() - w_.double()).abs()
            ratio = err / bound
            i = int(ratio.argmax()) if ratio.dim() else 0
            ok = ok and bool((err <= bound).all())
            e_max, b_at = float(err.max()), float(bound.flatten()[i] if bound.dim() else bound)
            if worst is None or float(ratio.max()) > worst[2]:
                worst = (e_max, b_at, float(ratio.max()))
        cuda_t, plain_t = timed or (cuda, plain)
        record(kname, acc_name, worst[0], worst[1], ok, timer(cuda_t),
               timer(plain_t, plain_reps), nbytes, flops, key=key)

    for form, vname, wname in sweeps:
        vt, wt = getattr(torch, vname), getattr(torch, wname)
        acc = acc_dtype(wt)
        an = str(acc).removeprefix("torch.")
        rounded = wt == torch.bfloat16
        V = torch.tensor(V64, dtype=vt, device="cuda")
        w = torch.tensor(w64, dtype=wt, device="cuda")
        u = torch.tensor(c64, dtype=wt, device="cuda")
        sV, sW, sA = V.element_size(), w.element_size(), acc.itemsize
        Va, wa, ua = V.to(acc).abs(), w.to(acc).abs(), u.to(acc).abs()

        def bnd(scale, plain_out, ulps=1.0):
            return form_bound(torch, an, scale, plain_out if rounded else None, ulps)

        for rows in (m1, MID_ROWS):
            key = form if rows == m1 else f"{form} rows {rows}"
            sw = wa + torch.mv(Va[:rows].t(), ua[:rows])
            g_p = ok_.gram_plain(V, w, rows)
            rec("basis_gram", key, an, [(wname, bnd(ok_.gram_plain(Va, wa, rows), g_p))],
                lambda: ok_.gram_cuda(V, w, rows), lambda: ok_.gram_plain(V, w, rows),
                rows * n * sV + n * sW, 2 * rows * n)
            w1_p, u2_p = ok_.update_gram_plain(V, w, u, rows)
            rec("basis_update_gram", key, an,
                [(wname, bnd(sw, w1_p)), (wname, bnd(ok_.gram_plain(Va, sw, rows), u2_p))],
                lambda: ok_.update_gram_cuda(V, w, u, rows),
                lambda: ok_.update_gram_plain(V, w, u, rows), rows * n * sV + 2 * n * sW,
                4 * rows * n)
            rec("basis_update_sumsq", key, an,
                [(wname, bnd(sw, w1_p)), (an, form_bound(torch, an, torch.dot(sw, sw)))],
                lambda: ok_.update_sumsq_cuda(V, w, u, rows),
                lambda: ok_.update_sumsq_plain(V, w, u, rows), rows * n * sV + 2 * n * sW,
                (2 * rows + 2) * n)
            rec("basis_update", key, an, [(wname, bnd(sw, ok_.update_plain(V, w, u, rows)))],
                lambda: ok_.update_cuda(V, w, u, rows),
                lambda: ok_.update_plain(V, w, u, rows), rows * n * sV + 2 * n * sW,
                2 * rows * n)
            if form in path["basis_gram2"]:
                vk = V[rows - 1].to(acc)
                u0, u1 = ok_.gram2_cuda(V, w, vk, rows).unbind(1)
                require(torch.equal(u0, ok_.gram_cuda(V, w, rows))
                        and torch.equal(u1, ok_.gram_cuda(V, vk, rows)),
                        f"K2x2 {key}: u0 and u1 bit-equal to K2's u of w and of row {rows - 1}")
                sg = form_bound(torch, an, ok_.gram_plain(Va, wa + vk.abs(), rows))
                rec("basis_gram2", key, an, [(an, sg), (an, sg)],
                    lambda: ok_.gram2_cuda(V, w, vk, rows).unbind(1),
                    lambda: ok_.gram2_plain(V, w, vk, rows).unbind(1),
                    rows * n * sV + 2 * n * sA, 4 * rows * n,
                    timed=(lambda: ok_.gram2_cuda(V, w, vk, rows),
                           lambda: ok_.gram2_plain(V, w, vk, rows)))
            # a bf16 w' carries up to CB_MGS_FLIPS flips, each one ulp of a
            # value the element took: at most |w| + sum |h_j| |v_j| (smw)
            sh, smw, sn = mgs_scale(torch, V.to(acc), w.to(acc), rows)
            h_p, wm_p, hn_p = mk.mgs_plain(V, w, rows)
            rec("basis_mgs", key, an,
                [(wname, bnd(sh, h_p)), (wname, bnd(smw, smw, CB_MGS_FLIPS)),
                 (wname, bnd(sn, hn_p))],
                lambda: mk.mgs_cuda(V, w, rows), lambda: mk.mgs_plain(V, w, rows),
                rows * n * sV + 2 * n * sW, (4 * rows + 2) * n, plain_reps=5)
            log(f"  basis_mgs {key}: {mk.mgs_cuda.grid[0]} blocks x {mk.mgs_cuda.grid[1]} "
                "register tiles")
        torch.cuda.synchronize()
        del V, w, u, Va, wa, ua
    for form, vname, yname, xname in axpys:
        V = torch.tensor(V64, dtype=getattr(torch, vname), device="cuda")
        y = torch.tensor(c64[:RLEN], dtype=getattr(torch, yname), device="cuda")
        x = torch.tensor(x64, dtype=getattr(torch, xname), device="cuda")
        # the increment is summed in the accumulation dtype of jnp's
        # promotion of (y, V); a bf16 one is rounded before the add
        inc = torch.promote_types(y.dtype, V.dtype)
        acc = acc_dtype(inc)
        an = str(acc).removeprefix("torch.")
        scale = x.abs().to(acc) + torch.mv(V[:RLEN].to(acc).abs().t(), y.to(acc).abs())
        inc_p = ou.basis_axpy_plain(torch.zeros_like(x), V, y)
        xk, xp = x.clone(), x.clone()
        rec("basis_axpy", form, an,
            [(xname, form_bound(torch, an, scale, inc_p if inc == torch.bfloat16 else None))],
            lambda: ou.basis_axpy_cuda(x.clone(), V, y),
            lambda: ou.basis_axpy_plain(x.clone(), V, y),
            RLEN * n * V.element_size() + 2 * n * x.element_size(), 2 * RLEN * n + n,
            timed=(lambda: ou.basis_axpy_cuda(xk, V, y), lambda: ou.basis_axpy_plain(xp, V, y)))
        del V, y, x, xk, xp
    torch.cuda.synchronize()
    record.require_ok()


def form_device_kernels():
    """For a fresh process (late in a long one the profiler records no
    device kernel): the device kernels one call of K2 and of K3 GRAM takes
    in each form at convdiff@1M (31 rows), and one call of K1's residual
    mode and of its residual lane form at s = 1, 2, 4, 8 (fp64 operator,
    the norm in fp32), printed as one JSON line."""
    import torch

    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk

    n, m1 = NX * NX, RLEN + 1
    out = {}
    offs = (-NX, -1, 0, 1, NX)
    data = torch.randn((len(offs), n), dtype=torch.float64, device="cuda")
    X, B = (torch.randn((8, n), dtype=torch.float64, device="cuda") for _ in range(2))
    out["dia_residual"] = device_kernels(
        torch, lambda: sk.dia_residual_cuda(data, offs, B[0], X[0], torch.float32))
    for s in sorted(sk.LANE_WIDTHS):
        out[f"dia_residual lanes{s}"] = device_kernels(
            torch, lambda: sk.dia_residual_lanes_cuda(data, offs, B[:s], X[:s], torch.float32))
    del data, X, B
    for form, vname, wname in cb_forms()[0]:
        vt, wt = getattr(torch, vname), getattr(torch, wname)
        V = torch.randn((m1, n), device="cuda").to(vt)
        w, u = torch.randn(n, device="cuda").to(wt), torch.randn(m1, device="cuda").to(wt)
        out[f"basis_gram {form}"] = device_kernels(torch, lambda: ok_.gram_cuda(V, w, m1))
        out[f"basis_update_gram {form}"] = device_kernels(
            torch, lambda: ok_.update_gram_cuda(V, w, u, m1))
    print(json.dumps(out), flush=True)


def cb_one_kernel_checks():
    """K2's and K3 GRAM's forms, and K1's residual mode and residual lane
    form, are one device kernel a call (counted in a fresh process)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; chip_smoke.form_device_kernels()"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=here)
    require(proc.returncode == 0, f"form device kernel counts: {proc.stderr[-3000:]}")
    for name, kernels in json.loads(proc.stdout.strip().splitlines()[-1]).items():
        log(f"  {name} device kernels a call (fresh process): {len(kernels)} {kernels}")
        require(len(kernels) == 1, f"{name}: one device kernel a call ({kernels})")


def cb_solve_walls(torch, A, A_dev):
    """Walls of whole solves at convdiff@1M, CGSR: mixed, mixed with a bf16
    basis, baseline and baseline with an fp32 basis, CB_WALL_REPS each after
    a warm-up, interleaved (the order reversed every other round)."""
    from gmres_tpu_torch import rand_vect, solve

    n = A.n_rows
    b = torch.tensor(-csr_residual(A, rand_vect(n, 42), np.zeros(n)), device="cuda")
    cfgs = {"mixed": config("mixed", "identity"), "mixed-cb": cb_config("mixed", "bfloat16"),
            "baseline": config("baseline", "identity"),
            "baseline-cb": cb_config("baseline", "float32")}
    walls = {k: [] for k in cfgs}
    for cfg in cfgs.values():
        solve(A_dev, b, cfg)  # warm-up
    for rep in range(CB_WALL_REPS):
        for k in (list(cfgs) if rep % 2 == 0 else list(cfgs)[::-1]):
            t0 = time.perf_counter()
            solve(A_dev, b, cfgs[k])
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"solve walls convdiff-cb (s, {CB_WALL_REPS} each after a warm-up"
        f"{', interleaved' if CB_WALL_REPS > 1 else ''}): "
        + "; ".join(f"{k} {walls_text(v)}" for k, v in walls.items())
        + f"; mixed-cb/mixed {med['mixed-cb'] / med['mixed']:.4f}, "
        f"baseline-cb/baseline {med['baseline-cb'] / med['baseline']:.4f}")


def bf16_spmv_beside_k1(torch, A_dev, copy_gbs):
    """The bf16 DIA SpMV (plain torch ops, the JAX package's XLA formula)
    beside K1 in fp32 on the same operator: whether a bf16 form of K1 would
    pay (the bytes bound of each alongside)."""
    from gmres_tpu_torch.ops.dia import dia_spmv

    timer = Timer(torch)
    x = torch.rand(A_dev.n_rows, device="cuda", dtype=torch.float64)
    n, D = A_dev.n_rows, len(A_dev.offsets)
    for dt in (torch.float32, torch.bfloat16):
        A = A_dev.astype(dt)
        xd = x.to(dt)
        ms = timer(lambda: dia_spmv(A, xd))
        log(f"  DIA SpMV {str(dt)[6:]} ({'K1' if dt == torch.float32 else 'plain torch'}): "
            f"{ms:.4f} ms; bytes bound "
            f"{(D + 2) * n * A.data.element_size() / (copy_gbs * 1e9) * 1e3:.4f} ms")


def convdiff_cb_path(torch, record, A, A_dev, mesh, mesh_dev):
    """The compressed-basis and bf16 path: the forms' kernel checks and
    device kernel counts, then at convdiff@1M (CGSR unless said) mixed with a
    bf16 basis (CB_RESTARTS), baseline with an fp32 basis (CB_RESTARTS),
    mixed-cb sequential MGS and ICWY, baseline-cb sequential MGS and ICWY,
    CB_CUT-restart solves that launch the remaining forms (orth_steps=3 in
    mixed-cb, baseline-cb and bf16; single with a bf16 basis; bf16 sequential
    MGS; bf16 with an fp32 outer loop), each within CB_CUT_FACTOR of its
    tier's full solve, mesh3d@1M mixed-cb, and the bf16 inner tier with its
    escalation, once (CB_BF16_STALL, CB_BF16_BEST, CB_BF16_AFTER); each
    converged solve at a backward error <= 1e-8.  Then the walls and the bf16 DIA SpMV beside K1.  Returns
    the path's launch counts."""
    from gmres_tpu_torch.ops.cuda import form_launch_counts, launch_counts, reset_launch_counts

    check_cb_kernels(torch, A.n_rows, record)
    cb_one_kernel_checks()
    reset_launch_counts()
    counts_by_solve = {}

    def run(label, mode, cfg, A_csr=A, A_op=A_dev, converges=True, history=False):
        before = launch_counts()
        res, _ = solve_timed(torch, f"convdiff-cb {label}", mode, A_csr, A_op, cfg, 1,
                             history=history, converges=converges, warm_up=False)
        after = launch_counts()
        c = {k: after[k] - before[k] for k in after}
        counts_by_solve[label] = c
        log(f"  launches {label}: {c}")
        require(all(c[k] == 0 for k in ILU_KERNELS + DF64_KERNELS + DIST_KERNELS),
                f"{label}: no K6, K8-K11 nor K12 ({c})")
        return res

    full = {}  # tier -> the backward error per cycle of its full CGSR solve

    def cut(label, tier, cfg, **kw):
        """A CB_CUT-restart solve, held within CB_CUT_FACTOR of its tier's
        full CGSR solve after as many restarts."""
        res = run(label, tier, cfg, converges=False, **kw)
        ref = full[tier][CB_CUT]
        ratio = res.backward_error / ref
        log(f"  {label}: backward error {res.backward_error:.3e} after {res.restarts} "
            f"restarts, {ratio:.3f} of {tier} CGSR's {ref:.3e}")
        require(res.restarts == CB_CUT and 1 / CB_CUT_FACTOR <= ratio <= CB_CUT_FACTOR,
                f"{label}: backward error {res.backward_error:.3e} after {res.restarts} "
                f"restarts not within {CB_CUT_FACTOR}x of {tier} CGSR's {ref:.3e}")

    for label, mode, basis in (("mixed-cb", "mixed", "bfloat16"),
                               ("baseline-cb", "baseline", "float32")):
        res = run(f"{label} cgsr", label, cb_config(mode, basis), history=True)
        full[label] = [h["rel_initial"] for h in res.history]
        lo, hi = CB_RESTARTS[label]
        log(f"  {label}: {res.restarts}/{res.total_iters} (held to {lo}..{hi} restarts)")
        require(lo <= res.restarts <= hi,
                f"{label}: {res.restarts}/{res.total_iters} not within {lo}..{hi} restarts")
        for form, low in (("sequential", False), ("icwy", True)):
            res = run(f"{label} mgs {form}", label, cb_config(mode, basis, orth="mgs",
                                                              low_sync_mgs=low))
            log(f"  {label} mgs {form}: {res.restarts}/{res.total_iters}")
        cut(f"{label} orth_steps=3", label,
            cb_config(mode, basis, orth_steps=3, max_restarts=CB_CUT))
    # single with a bf16 basis: the mixed-cb tier's iteration in an fp32 outer loop
    cut("single-cb", "mixed-cb", cb_config("single", "bfloat16", max_restarts=CB_CUT))
    res = run("mesh3d mixed-cb", "mixed-cb", cb_config("mixed", "bfloat16"), A_csr=mesh,
              A_op=mesh_dev)
    log(f"  mesh3d mixed-cb: {res.restarts}/{res.total_iters}")

    # the bf16 inner tier, once, with its stall escalation: the bf16 cycles
    # reach CB_BF16_BEST, stall within CB_BF16_STALL restarts and the fp32
    # continuation converges within CB_BF16_AFTER
    res = run("bf16 cgsr", "bf16", bf16_config(), history=True)
    marks = [i for i, h in enumerate(res.history) if h.get("escalated")]
    before = marks[0] if marks else res.restarts
    bf16_rels = [h["rel_initial"] for h in res.history[:before]]
    full["bf16"] = bf16_rels
    best = min(bf16_rels)
    log(f"  bf16 inner, escalation on: converged={res.converged} escalated={res.escalated} "
        f"restarts {before} in bf16 (best backward error {best:.3e}), "
        f"{res.restarts - before} after")
    require(res.converged and (res.escalated or not marks),
            f"bf16: escalated and converged, or converged without a stall "
            f"(escalated={res.escalated})")
    require(best <= CB_BF16_BEST, f"bf16: best backward error of the bf16 cycles "
            f"{best:.3e} <= {CB_BF16_BEST:.0e}")
    if res.escalated:
        lo, hi = CB_BF16_STALL
        require(lo <= before <= hi and res.restarts - before <= CB_BF16_AFTER,
                f"bf16: stalled after {before} restarts (held to {lo}..{hi}) and converged "
                f"{res.restarts - before} after (held to <= {CB_BF16_AFTER})")
    for label, cfg in (("bf16 mgs sequential", bf16_config(orth="mgs", low_sync_mgs=False,
                                                           max_restarts=CB_CUT)),
                       ("bf16 orth_steps=3", bf16_config(orth_steps=3, max_restarts=CB_CUT)),
                       ("bf16 fp32 outer", bf16_config(outer="float32",
                                                       max_restarts=CB_CUT))):
        cut(label, "bf16", cfg)
    counts = launch_counts()
    forms = form_launch_counts()
    log(f"  launches convdiff-cb: {counts}")
    log(f"  form launches convdiff-cb: {forms}")
    for name, want in cb_forms()[2].items():
        require(all(forms[name].get(f, 0) > 0 for f in want),
                f"convdiff-cb: {name} launched in every form {sorted(want)} ({forms[name]})")
    require(counts["dia_spmv"] > 0 and counts["dia_residual"] > 0 and counts["sell_spmv"] > 0
            and counts["sell_residual"] > 0, f"convdiff-cb: K1 and K5 launched ({counts})")
    require(all(counts[k] == 0 for k in ILU_KERNELS + DF64_KERNELS + DIST_KERNELS),
            f"convdiff-cb: no K6, K8-K11 nor K12 ({counts})")
    cb_solve_walls(torch, A, A_dev)
    bf16_spmv_beside_k1(torch, A_dev, record.copy_gbs)
    return counts, forms


def run_main(main_fn, argv, label):
    """main_fn(argv) with its standard output captured and logged; returns
    the output.  A nonzero exit code fails the run."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    out = buf.getvalue()
    log(f"{label} ({time.perf_counter() - t0:.1f} s): {' '.join(argv)}")
    for line in out.splitlines():
        log(f"  | {line}")
    require(rc == 0, f"{label}: exit code {rc}")
    return out


def check_condest_operators(torch, A_csr, label):
    """condest's operators of A_csr on the card (fp64 DIA or sliced ELL, A
    and A^T): K1's or K5's plain mode held to its plain version at these
    shapes, outside the counted runs.  Returns the route's type name."""
    from gmres_tpu_torch.ops.cuda import sell_kernel as sl
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import DIAMatrix
    from gmres_tpu_torch.solver.condest import condest_operators

    ops = condest_operators(A_csr, torch.device("cuda"))
    x = torch.tensor(np.random.default_rng(3).standard_normal(A_csr.n_rows),
                     dtype=torch.float64, device="cuda")
    for name, op in zip(("A", "A^T"), ops):
        require(op.dtype == torch.float64, f"condest {label}: {name} in fp64")
        if isinstance(op, DIAMatrix):
            got = sk.dia_spmv_cuda(op.data, op.offsets, x)
            want = sk.dia_spmv_plain(op.data, op.offsets, x)
            scale = sk.dia_spmv_plain(op.data.abs(), op.offsets, x.abs())
        else:
            got = sl.sell_spmv_cuda(op.vals, op.cols, op.slice_ptr, x, op.n_rows)
            want = sl.sell_spmv_plain(op.vals, op.cols, op.slice_ptr, x, op.n_rows)
            scale = sl.sell_spmv_plain(op.vals.abs(), op.cols, op.slice_ptr, x.abs(), op.n_rows)
        err, bound, ok = compare("float64", [got], [want], [scale])
        log(f"condest {label}: {name} {type(op).__name__} fp64 kernel against its plain "
            f"version: max_abs_err={err:.3e} (tol {bound:.3e})")
        require(ok, f"condest {label}: the {name} product on the card agrees with its plain "
                    f"version ({err:.3e} > {bound:.3e})")
    return type(ops[0]).__name__


def cli_path(torch, A, tmp, a_path, write_seconds, dist_clis):
    """The cli phase, after the eight paths: the reference-format entry
    points, each called in-process through its main(argv) or the package's
    functions, at convdiff@1M (A), whose ``.mtx`` the distributed path wrote
    to ``a_path`` in ``tmp`` (the phase removes ``tmp``); rank 0's output of
    that path's ``--dist`` command line (``dist_clis``) is held to the
    single-device command's block.  Returns the phase's launch counts: the
    sum of each entry point's own, read around its main(argv) call alone,
    and its sweep rows."""
    import shutil

    from gmres_tpu_torch import GmresConfig, load_matrix, load_vector, rand_vect, solve
    from gmres_tpu_torch.cli import condest_cli
    from gmres_tpu_torch.cli import solve as cli
    from gmres_tpu_torch.experiments import findmin, history, sweep
    from gmres_tpu_torch.io import mmio
    from gmres_tpu_torch.ops.cuda import form_launch_counts, launch_counts, reset_launch_counts
    from gmres_tpu_torch.solver import condest as ce

    try:
        # 1. I/O: the matrix, x_true and b through MatrixMarket files
        n = A.n_rows
        rp, ci, v = A.numpy_arrays()
        t1 = time.perf_counter()
        B = load_matrix(a_path)
        t2 = time.perf_counter()
        log(f"cli I/O: write_coordinate of convdiff@1M ({A.nnz:,} entries, "
            f"{os.path.getsize(a_path) / 2 ** 20:.1f} MiB; on the distributed path) "
            f"{write_seconds:.3f} s; load_matrix {t2 - t1:.3f} s")
        require(np.array_equal(B.row_ptr.numpy(), rp) and np.array_equal(B.col_idx.numpy(), ci)
                and B.vals.numpy().tobytes() == v.tobytes(),
                "load_matrix gives back the written CSR arrays")
        x_true = rand_vect(n, 42)
        b = cli.host_spmv(A, x_true)
        x_path, b_path = os.path.join(tmp, "x_true.mtx"), os.path.join(tmp, "b.mtx")
        t0 = time.perf_counter()
        mmio.write_array(x_path, x_true)
        mmio.write_array(b_path, b)
        t1 = time.perf_counter()
        b_back, x_back = load_vector(b_path), load_vector(x_path)
        log(f"cli I/O: write_array of x_true and b {t1 - t0:.3f} s; load_vector of both "
            f"{time.perf_counter() - t1:.3f} s")
        require(b_back.tobytes() == b.tobytes() and x_back.tobytes() == x_true.tobytes(),
                "load_vector gives back the written b and x_true")
        del B, b_back, x_back

        # 2. the solve command line at that file; each entry point's launches
        # are counted around its own call, and the phase's counts are their sum
        counts, dtypes = Counter(), Counter()

        def counted(label, main_fn, argv):
            reset_launch_counts()
            out = run_main(main_fn, argv, label)
            c, forms = launch_counts(), form_launch_counts()
            k15 = {(k, f): v for k in ("dia_spmv", "sell_spmv") for f, v in forms[k].items()}
            log(f"  launches {label}: { {k: v for k, v in c.items() if v} }; K1 and K5 by "
                f"dtype: {k15}")
            require(all(c[k] == 0 for k in DF64_KERNELS + DIST_KERNELS),
                    f"{label}: no K8-K12 ({c})")
            counts.update(c)
            dtypes.update(k15)
            return out, c, forms

        runs, outs = {}, {}
        for label, extra, kernels, k1_form in CLI_SOLVES:
            extra = [b_path if f is None else f for f in extra]
            argv = ["--Apath", a_path, "--rlen", "30", "--tol", "1e-8", "--json", *extra]
            out, c, forms = counted(f"cli solve {label}", cli.main, argv)
            outs[label] = (argv, out)
            m = re.search(SUMMARY_REGEX, out)
            require(m is not None, f"cli solve {label}: the summary block parses")
            res = json.loads(out.splitlines()[-1])
            require(res["converged"] and (int(m.group(3)), int(m.group(4))) ==
                    (res["i"], res["total_iters"]),
                    f"cli solve {label}: converged, the block's counts are the JSON's")
            require(all(c[k] > 0 for k in kernels) and set(forms["dia_spmv"]) == {k1_form}
                    and c["sell_spmv"] == 0,
                    f"cli solve {label}: launched {kernels}, K1 in {k1_form} only, no K5 ({c}, "
                    f"K1 {forms['dia_spmv']})")
            runs[label] = res
        for label in ("mixed cgsr", "baseline cgsr --bpath"):
            r = runs[label]
            require(abs(r["i"] - CLI_HISTORY[0]) <= 1,
                    f"cli solve {label}: {r['i']}/{r['total_iters']} within one restart of "
                    f"{CLI_HISTORY[0]}/{CLI_HISTORY[1]}")
        direct = solve(load_matrix(a_path), b, GmresConfig.from_flags(mode="mixed", tol=1e-8))
        r = runs["defaults (mgs, ilu) mixed"]
        log(f"cli solve defaults: {r['i']}/{r['total_iters']}; the same gmres_tpu_torch.solve "
            f"called directly: {direct.restarts}/{direct.total_iters}")
        require((r["i"], r["total_iters"]) == (direct.restarts, direct.total_iters),
                "cli solve defaults: the counts of the same solve called directly")
        del direct

        # 2b. the --dist command line on the distributed path's ranks
        rc, out, seconds, _ = dist_clis[0]
        single = outs["mixed cgsr"][1]
        log(f"cli solve --dist on {DIST_RANKS} ranks ({seconds:.1f} s on rank 0, on the "
            f"distributed path): {' '.join(['--dist', *CLI_DIST_ARGV])}")
        for line in out.splitlines():
            log(f"  | {line}")
        m, ms = re.search(SUMMARY_REGEX, out), re.search(SUMMARY_REGEX, single)
        require(rc == 0 and m is not None and out.splitlines()[:4] == single.splitlines()[:4]
                and m.group(2) == ms.group(2) and abs(int(m.group(3)) - CLI_HISTORY[0]) <= 1,
                f"cli solve --dist: rank 0 prints the single-device block with "
                f"{CLI_HISTORY[0]}/{CLI_HISTORY[1]} within one restart")
        log(f"  the single-device command's counts: {ms.group(3)}/{ms.group(4)}; --dist: "
            f"{m.group(3)}/{m.group(4)}")

        # 3. condest through its command line, each operator checked first
        stats = {}
        real = ce.condest
        ce.condest = lambda *a, **kw: real(*a, stats=stats, **kw)
        try:
            for spec, max_iters, smax_tpu, smin_tpu, t_tpu in CONDEST_RUNS:
                route = check_condest_operators(torch, cli.make_synth(spec), spec)
                t0 = time.perf_counter()
                out, c, forms = counted(f"condest {spec}", condest_cli.main,
                                        ["--synth", spec, "--max-iters", str(max_iters)])
                wall = time.perf_counter() - t0
                smax = float(re.search(r"sigma_max = (\S+)", out).group(1))
                t = int(re.search(r"(\d+) iterations total", out).group(1))
                cond, _, smin = (float(g) for g in re.search(
                    r"Computed cond\(A\) = (\S+) = (\S+)/(\S+)", out).groups())
                log(f"condest {spec} on {route}: t={t} (capped: {t == max_iters + 1}; the "
                    f"TPU's {t_tpu}) sigma_max={smax} (the TPU's {smax_tpu}) "
                    f"sigma_min={smin} (the TPU's {smin_tpu}) cond={cond}; {wall:.1f} s, "
                    f"power iteration {stats['power_steps']} steps "
                    f"{stats['power_seconds']:.3f} s, LSQR {stats['lsqr_steps']} steps "
                    f"{stats['lsqr_seconds']:.3f} s = "
                    f"{stats['lsqr_seconds'] / stats['lsqr_steps'] * 1e3:.4f} ms a step "
                    f"(flags read every {stats['chunk']} steps)")
                require(abs(smax - smax_tpu) <= CONDEST_SIGMA_MAX_REL * smax_tpu,
                        f"condest {spec}: sigma_max {smax} within "
                        f"{CONDEST_SIGMA_MAX_REL:g} of the TPU's {smax_tpu}")
                mine, other = (("sell_spmv", "dia_spmv") if spec.startswith("mesh3d")
                               else ("dia_spmv", "sell_spmv"))
                require(c[mine] > 0 and c[other] == 0 and forms[mine] == {"f64": c[mine]},
                        f"condest {spec}: {mine} in fp64 only, no {other} ({c}, "
                        f"{forms[mine]})")
                if spec.startswith("mesh3d"):
                    ref, jax_cond = CONDEST_MESH3D_EXTENDED, CONDEST_MESH3D_JAX_FP64
                    tpu = smax_tpu / smin_tpu
                    log(f"condest {spec}: cond {cond} is {abs(cond - ref) / ref:.3e} from the "
                        f"extended-precision estimate {ref!r}, "
                        f"{abs(cond - jax_cond) / jax_cond:.3e} from the JAX package's fp64 "
                        f"{jax_cond!r} and {abs(cond - tpu) / tpu:.3e} from the TPU's {tpu:.6g}")
                    require(abs(t - t_tpu) <= CONDEST_T_SLACK
                            and abs(cond - ref) <= CONDEST_COND_REL * ref,
                            f"condest {spec}: t={t} within {CONDEST_T_SLACK} of {t_tpu} "
                            f"and cond {cond} within {CONDEST_COND_REL:g} of the "
                            f"extended-precision estimate {ref!r}")
        finally:
            ce.condest = real

        # 4. the sweep over the phase's .mtx file (MTXDIR), then findmin
        os.environ["MTXDIR"] = tmp
        try:
            _, c, forms = counted("sweep", sweep.main,
                                  ["--device", "cuda", "--prec", "identity", "--orth", "cgsr",
                                   "--no-singleprec", "--no-single", "--warmup", "0",
                                   "--out-dir", tmp, "convdiff_1m", "30", "0", "1e-8", "42"])
        finally:
            del os.environ["MTXDIR"]
        require(all(c[k] > 0 for k in CLI_SOLVES[0][2])
                and set(forms["dia_spmv"]) == {"f32", "f64"},
                f"sweep: launched {CLI_SOLVES[0][2]}, K1 in fp32 and fp64 ({c}, "
                f"K1 {forms['dia_spmv']})")
        rows = history.read_history("convdiff_1m", tmp)
        log(f"sweep rows: {rows}")
        require([r["type"] for r in rows] == ["b", "mp"] and all(
            r["device"] == "cuda" and r["i"] != "-"
            and abs(int(r["i"]) - CLI_HISTORY[0]) <= 1 for r in rows),
            f"sweep: a baseline and a mixed row on cuda, each within one restart of "
            f"{CLI_HISTORY[0]}/{CLI_HISTORY[1]}")
        out = counted("findmin", findmin.main, ["--plotting-format", "--in-dir", tmp, "1e-8",
                                                "cgsr", "cuda", "identity", "convdiff_1m"])[0]
        require(out.startswith("'convdiff_1m': [("), "findmin: the plotting line")
        counts = {k: counts[k] for k in launch_counts()}
        sweep_rows = rows
        log(f"  launches cli (the entry points' runs): {counts}")
        log(f"  K1 and K5 launches by dtype, cli: {dict(dtypes)}")
        require({k for k, v in counts.items() if v} >= {k for r in CLI_SOLVES for k in r[2]}
                | {"sell_spmv"} and set(dtypes) == {("dia_spmv", "f32"), ("dia_spmv", "f64"),
                                                      ("sell_spmv", "f64")},
                f"cli: K1 (fp32 and fp64), K1 residual, K2, K3 GRAM and SUMSQ, K4, K5 fp64, "
                f"K6 fused and K7 launched ({counts}, {dict(dtypes)})")
        return counts, sweep_rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_lane_kernels(torch, A_csr, record):
    """K1's lane form at every lane count a launch takes (1, 2, 4 and 8,
    ``spmv_kernel.LANE_WIDTHS``), fp32 and fp64, in both
    modes: each lane bit for bit against K1 on that lane (plain mode on the
    strided view V[:, 1, :] of a lane basis; residual mode with each lane's
    two sums, the norm demoted to fp32 and kept in fp64), the whole against
    the lane plain versions within TOL_REL (an FMA against a multiply and an
    add), timed beside the bound ((D + 2s) n values in plain mode, (D + 3s) n
    fp64 values in residual mode) and the one PyTorch call, torch.sparse.mm
    of the CSR matrix by the (n, s) block; a lane's time beside K1's."""
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import from_csr

    dia = from_csr(A_csr)
    n, offs = dia.n_rows, dia.offsets
    D = len(offs)
    widths = sorted(sk.LANE_WIDTHS)
    smax = max(widths)
    rng = np.random.default_rng(BATCHED_SEED)
    timer = Timer(torch)
    V_np = rng.standard_normal((smax, 3, n))
    d64 = dia.data.to("cuda", torch.float64)
    B64 = torch.tensor(rng.standard_normal((smax, n)), device="cuda")
    X64 = torch.tensor(rng.random((smax, n)), device="cuda")
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        sfx = "f32" if dt == torch.float32 else "f64"
        data = dia.data.to("cuda", dt)
        V = torch.tensor(V_np, dtype=dt, device="cuda")
        x0 = V[0, 1].contiguous()
        k1_ms = timer(lambda: sk.dia_spmv_cuda(data, offs, x0))
        Acsr = csr_tensor(torch, A_csr, dt)
        for s in widths:
            X = V[:s, 1]
            got = sk.dia_spmv_lanes_cuda(data, offs, X)
            bits = all(torch.equal(got[j], sk.dia_spmv_cuda(data, offs, X[j].contiguous()))
                       for j in range(s))
            want = sk.dia_spmv_lanes_plain(data, offs, X)
            err, bound, ok = compare(dt_name, [got], [want],
                                     [sk.dia_spmv_lanes_plain(data.abs(), offs, X.abs())])
            Xt = X.t().contiguous()
            ms = timer(lambda: sk.dia_spmv_lanes_cuda(data, offs, X))
            log(f"  K1 lane form {dt_name} s={s}: every lane bit-equal to K1: {bits}; {ms:.4f} "
                f"ms, {ms / s:.4f} ms a lane against K1's {k1_ms:.4f} ms")
            record("dia_spmv", dt_name, err, bound, ok and bits, ms,
                   timer(lambda: sk.dia_spmv_lanes_plain(data, offs, X)),
                   (D + 2 * s) * n * dt.itemsize, 2 * D * n * s,
                   timer(lambda: torch.sparse.mm(Acsr, Xt)), key=f"{sfx}_lanes{s}")
        del Acsr, V, data
        for s in widths:
            args = (d64, offs, B64[:s], X64[:s], dt)
            got = sk.dia_residual_lanes_cuda(*args)
            ones = [sk.dia_residual_cuda(d64, offs, B64[j], X64[j], dt) for j in range(s)]
            bits = all(torch.equal(g[j], one[i]) for j, one in enumerate(ones)
                       for i, g in enumerate(got))
            want = sk.dia_residual_lanes_plain(*args)
            scale = B64[:s].abs() + sk.dia_spmv_lanes_plain(d64.abs(), offs, X64[:s])
            err, bound, ok = compare("float64", got[:1], want[:1], [scale])
            ss_err = max(float((g - w).abs().max() / w.abs().min())
                         for g, w in zip(got[1:], want[1:]))
            ss_tol = 1e-5 if dt == torch.float32 else 1e-12
            ms = timer(lambda: sk.dia_residual_lanes_cuda(*args))
            log(f"  K1 residual lane form, {dt_name} norm, s={s}: every lane bit-equal to K1's "
                f"residual mode: {bits}; sums of squares rel err {ss_err:.3e} (tol {ss_tol:.0e})"
                f"; {ms:.4f} ms, {ms / s:.4f} ms a lane")
            record("dia_residual", dt_name, err, bound, ok and bits and ss_err <= ss_tol, ms,
                   timer(lambda: sk.dia_residual_lanes_plain(*args)), (D + 3 * s) * n * 8,
                   (2 * D + 5) * n * s, key=f"{dt_name}_lanes{s}")
    record.require_ok()


# device kernel name -> the port's kernel, for the traces: K2x2 is K2's
# template with two vectors, its last template argument 2
# (basis_gram_kernel<TV, TW, aligned, NV>); K1's lane form is K1's template
# over 2, 4 or 8 lanes (dia_spmv_kernel<T, RESIDUAL, aligned, L>)
KERNEL_GROUPS = (("K1 lane form", r"dia_spmv_kernel<[^>]*,\s*[248]>"),
                 ("K1", r"dia_spmv_kernel"), ("K2x2", r"basis_gram_kernel<[^>]*,\s*2>"),
                 ("K2", r"basis_gram_kernel"),
                 ("K3 GRAM", r"basis_update_gram"), ("K3 SUMSQ", r"basis_update_kernel"),
                 ("K4", r"basis_axpy_kernel"))


def kernel_group(name):
    return next((g for g, pat in KERNEL_GROUPS if re.search(pat, name)), "torch")


def batched_trace():
    """Run in a fresh process (``python3 -c "import chip_smoke;
    chip_smoke.batched_trace()"``; late in a long one torch.profiler records
    no device kernel): BATCHED_TRACE_RESTARTS cycles of the s = 8 mixed
    batched solve at convdiff@1M under utils.profiling.trace, after a
    warm-up and an untraced run of the same.  Prints one JSON line: the
    untraced and traced walls a step, the device's busy time a step (the
    union of the traced run's device intervals) and its share of the
    untraced wall (the profiler slows the host many times over, so the
    traced wall is no step's wall), and the device time a step by kernel."""
    import shutil
    import tempfile

    import torch

    from gmres_tpu_torch import rand_vect, solve_batched, stage
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.utils.profiling import trace

    A = convection_diffusion_2d(NX, beta=2.0)
    A_dev = stage(A)
    n, s = A.n_rows, 8
    B = torch.tensor(np.stack([-csr_residual(A, rand_vect(n, BATCHED_SEED + j), np.zeros(n))
                               for j in range(s)]), device="cuda")
    cfg = config("mixed", "jacobi", max_restarts=BATCHED_TRACE_RESTARTS)
    solve_batched(A_dev, B, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_batched(A_dev, B, cfg)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    steps = res[0].total_iters
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        t0 = time.perf_counter()
        with trace(tmp) as prof:
            solve_batched(A_dev, B, cfg)
        traced = time.perf_counter() - t0
        trace_mb = os.path.getsize(os.path.join(tmp, "trace.json")) / 2 ** 20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spans, by_kernel = [], Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t_start, t_end = e.time_range.start, e.time_range.end
        spans.append((t_start, t_end))
        by_kernel[kernel_group(e.name)] += (t_end - t_start) / steps / 1e3
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    print(json.dumps({"lanes": s, "steps": steps, "cycles": res[0].restarts,
                      "device_events": len(spans), "trace_mb": trace_mb,
                      "untraced_ms_per_step": untraced / steps * 1e3,
                      "traced_ms_per_step": traced / steps * 1e3,
                      "device_busy_ms_per_step": busy / 1e3 / steps,
                      "device_busy_share": busy / 1e6 / untraced,
                      "device_busy_share_traced": busy / 1e6 / traced,
                      "device_ms_per_step": dict(by_kernel)}), flush=True)


def bench_kernel_times(torch, A):
    """K1 on convdiff@1M, and K2, K3 GRAM and K3 SUMSQ over 31 rows of
    N(0, 1/n) values, fp32 and fp64, under bench_kernels' own timer
    (``_timed``, BENCH_TRIALS calls a reading) on this script's operands,
    BENCH_REPEATS readings each: {(the bench's key, dtype): (median, min,
    max) ms}."""
    from gmres_tpu_torch.cli.bench_kernels import _timed
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import from_csr

    dia = from_csr(A)
    n, m, nnz = A.n_rows, RLEN + 1, A.nnz
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        size = dt.itemsize
        data = dia.data.to("cuda", dt)
        V = torch.randn((m, n), generator=gen, dtype=dt, device="cuda") / np.sqrt(n)
        w = torch.randn(n, generator=gen, dtype=dt, device="cuda")
        u = torch.randn(m, generator=gen, dtype=dt, device="cuda")
        ops = (("spmv_dia", lambda d, V, w, u: sk.dia_spmv_cuda(d, dia.offsets, w),
                nnz * (size + 4) + 2 * n * size),
               ("gram", lambda d, V, w, u: ok_.gram_cuda(V, w, m), (m + 1) * n * size),
               ("update_gram", lambda d, V, w, u: ok_.update_gram_cuda(V, w, u, m),
                (m + 2) * n * size),
               ("update_sumsq", lambda d, V, w, u: ok_.update_sumsq_cuda(V, w, u, m),
                (m + 2) * n * size))
        for key, fn, nbytes in ops:
            def make(fn=fn):
                args = [t.clone() for t in (data, V, w, u)]
                return lambda: fn(*args)
            ms = [_timed(make, nbytes, BENCH_TRIALS, torch.device("cuda")) * 1e3
                  for _ in range(BENCH_REPEATS)]
            out[(key, dt_name)] = (statistics.median(ms), min(ms), max(ms))
        del data, V
    return out


def batched_path(torch, record, A, A_dev, sweep_rows):
    """The batched phase, after the cli phase: K1's lane form against K1 and
    its plain version (check_lane_kernels); solve_batched at convdiff@1M per
    BATCHED_SOLVES, each lane converged within one restart of
    BATCHED_HISTORY, with the counts of the port's solve of its b in the same
    run, at a backward error <= 1e-8 recomputed here in fp64; the batched
    wall beside the s sequential solves' (BATCHED_WALL_REPS each, after a
    batched warm-up); where a batched step's time goes
    (batched_trace, a fresh process); bench_kernels in-process, its K1, K2
    and K3 times beside its own timer's on this script's operands; the
    analysis tables on the cli phase's sweep rows.  The launches are read
    around each batched solve alone; each part logs its seconds.  Returns
    the phase's launch counts and {(kernel, lane variant): launches}."""
    import contextlib
    import io
    import shutil
    import tempfile

    from gmres_tpu_torch import rand_vect, solve, solve_batched
    from gmres_tpu_torch.cli import bench_kernels
    from gmres_tpu_torch.experiments import analysis, history
    from gmres_tpu_torch.ops.cuda import form_launch_counts, launch_counts, reset_launch_counts

    t_part = time.perf_counter()

    def part_seconds(name):
        nonlocal t_part
        log(f"batched phase, {name}: {time.perf_counter() - t_part:.1f} s")
        t_part = time.perf_counter()

    check_lane_kernels(torch, A, record)
    part_seconds("K1's lane form checks")
    n = A.n_rows
    smax = max(s for _, s in BATCHED_SOLVES)
    x_true = [rand_vect(n, BATCHED_SEED + j) for j in range(smax)]
    B = np.stack([-csr_residual(A, x, np.zeros(n)) for x in x_true])
    B_dev = torch.tensor(B, device="cuda")
    a_fro = float(np.linalg.norm(A.vals.numpy()))
    counts, lane_launches = Counter(), Counter()

    def batched(mode, cfg, Bs):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve_batched(A_dev, Bs, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c, forms = launch_counts(), form_launch_counts()
        label = f"batched {mode} s={Bs.shape[0]}"
        require(all(c[k] > 0 for k in BATCHED_KERNELS)
                and all(v == 0 for k, v in c.items() if k not in BATCHED_KERNELS),
                f"{label}: launched {BATCHED_KERNELS} and no other kernel ({c})")
        require(all("_lanes" in f for k in ("dia_spmv", "dia_residual") for f in forms[k]),
                f"{label}: K1 in its lane form only, both modes ({forms['dia_spmv']}, "
                f"{forms['dia_residual']})")
        counts.update(c)
        norm = "float32" if mode == "mixed" else "float64"
        for f, v in forms["dia_spmv"].items():
            lane_launches[("dia_spmv", f)] += v
        for f, v in forms["dia_residual"].items():
            lane_launches[("dia_residual", f"{norm}_{f.split('_', 1)[1]}")] += v
        return res, wall

    def lanes_checked(label, res, seq):
        lines = []
        for j, (r, one) in enumerate(zip(res, seq)):
            x = r.x.cpu().numpy()
            backward = float(np.linalg.norm(csr_residual(A, x, B[j]))
                             / (np.linalg.norm(B[j]) + a_fro * np.linalg.norm(x)))
            lines.append(f"{r.restarts}/{r.total_iters} (solve {one.restarts}/"
                         f"{one.total_iters}, backward {backward:.2e})")
            require(r.converged and abs(r.restarts - BATCHED_HISTORY[0]) <= 1
                    and (r.restarts, r.total_iters) == (one.restarts, one.total_iters)
                    and backward <= 1e-8,
                    f"{label} lane {j}: {r.restarts}/{r.total_iters} converged={r.converged} "
                    f"within one restart of {BATCHED_HISTORY[0]}/{BATCHED_HISTORY[1]} and equal "
                    f"to solve's {one.restarts}/{one.total_iters}, backward error "
                    f"{backward:.3e} <= 1e-8")
        log(f"{label}: lanes {'; '.join(lines)}")

    # per solve, its batched runs with the sequential solves of its lanes
    # interleaved
    for mode, s in BATCHED_SOLVES:
        label = f"batched {mode} s={s}"
        cfg = config(mode, "jacobi")
        batched(mode, cfg, B_dev[:s])   # warm-up
        bwalls, swalls = [], []
        for _ in range(BATCHED_WALL_REPS):
            res, wall = batched(mode, cfg, B_dev[:s])
            bwalls.append(wall)
            seq, wall = [], 0.0
            for j in range(s):
                t0 = time.perf_counter()
                seq.append(solve(A_dev, B_dev[j], cfg))
                torch.cuda.synchronize()
                wall += time.perf_counter() - t0
            swalls.append(wall)
        lanes_checked(label, res, seq)
        bw, sw = statistics.median(bwalls), statistics.median(swalls)
        log(f"{label}: wall {walls_text(bwalls)} s against {s} sequential solves' "
            f"{walls_text(swalls)} s, after a batched warm-up: batched/sequential "
            f"{bw / sw:.4f}")
        del res, seq
        part_seconds(label)

    # where a batched step's time goes, in a fresh process
    out = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.batched_trace()"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=600)
    require(out.returncode == 0, f"batched_trace failed ({out.returncode}): {out.stderr[-2000:]}")
    tr = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"batched trace (s=8 mixed, {tr['cycles']} cycles, {tr['steps']} steps, "
        f"{tr['device_events']} device events): host wall a step {tr['untraced_ms_per_step']:.4f}"
        f" ms untraced, {tr['traced_ms_per_step']:.4f} ms traced; device busy "
        f"{tr['device_busy_ms_per_step']:.4f} ms a step, {tr['device_busy_share']:.4f} of the "
        f"untraced wall ({tr['device_busy_share_traced']:.4f} of the traced); device ms a step: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(tr["device_ms_per_step"].items(),
                                                      key=lambda kv: -kv[1])))
    require(tr["device_events"] > 0, "batched trace: torch.profiler recorded device kernels")
    part_seconds("the trace")

    # bench_kernels, in-process: its K1, K2, K3 GRAM and K3 SUMSQ beside the
    # same kernels under its own timer on this script's operands
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = bench_kernels.main(["--synth", "convdiff:1024", "--trials", str(BENCH_TRIALS),
                                 "--json"])
    log(f"bench_kernels ({time.perf_counter() - t0:.1f} s):")
    for line in err.getvalue().splitlines():
        log(f"  | {line}")
    require(rc == 0, f"bench_kernels: exit code {rc}")
    bench = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"bench_kernels JSON: {json.dumps(bench)}")
    for (key, dt_name), (med, lo, hi) in sorted(bench_kernel_times(torch, A).items()):
        got = bench[f"{key}_{'f32' if dt_name == 'float32' else 'f64'}"]["seconds"] * 1e3
        ok = BENCH_AGREE[0] * lo <= got <= BENCH_AGREE[1] * hi
        log(f"  bench_kernels {key} {dt_name}: {got:.4f} ms against its timer's {med:.4f} ms on "
            f"this script's operands (spread {lo:.4f}..{hi:.4f}, {BENCH_REPEATS} readings): "
            f"{got / med:.3f} of the median, {got / lo:.3f} of the least, {got / hi:.3f} of the "
            f"most {'ok' if ok else 'FAIL'}")
        require(ok, f"bench_kernels {key} {dt_name}: {got:.4f} ms within "
                f"{BENCH_AGREE[0]}..{BENCH_AGREE[1]} of its timer's spread {lo:.4f}..{hi:.4f}")
    part_seconds("bench_kernels")

    # the analysis tables on the cli phase's sweep rows
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    try:
        history.append_rows("convdiff_1m", sweep_rows, tmp)
        out = run_main(analysis.main, ["--in-dir", tmp, "--latex", "1e-8", "cgsr", "cuda",
                                       "identity", "convdiff_1m"], "analysis")
        require("geometric mean" in out and "convdiff_1m" in out,
                "analysis: the speedup line and the LaTeX table of the sweep's rows")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    part_seconds("analysis")
    return {k: counts[k] for k in launch_counts()}, lane_launches


def k6_main(torch, parent) -> int:
    """K6's section alone (``--k6``): its checks and tables at convdiff@1M
    and the form table at convdiff(2048), then, with ``--parent DIR``, K6
    beside that checkout's."""
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.cuda._build import library

    t0 = time.perf_counter()
    library()
    log(f"kernel build+load: {time.perf_counter() - t0:.3f} s")
    record = Records(copy_bandwidth(torch)[1])
    A = convection_diffusion_2d(NX, beta=2.0)
    t0 = time.perf_counter()
    check_trisolve_kernels(torch, A, record)
    log(f"K6 section: {time.perf_counter() - t0:.1f} s")
    if parent:
        t0 = time.perf_counter()
        k6_beside_checkout(torch, A, parent)
        log(f"K6 beside {parent}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {"kind": torch.cuda.get_device_name(0)}}),
          flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke run of gmres_tpu_torch.")
    ap.add_argument("--k6", action="store_true", help="run K6's section alone")
    ap.add_argument("--parent", metavar="DIR",
                    help="with --k6: time K6 beside the K6 of the checkout at DIR")
    args = ap.parse_args(argv)
    if args.parent and not args.k6:
        ap.error("--parent goes with --k6")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 reference products

    from gmres_tpu_torch.ops.cuda import kernel_wrappers
    from gmres_tpu_torch.ops.cuda._build import library

    for line in device_lines():
        log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"nvcc: {nvcc_version()}")
    if args.k6:
        return k6_main(torch, args.parent)

    t0 = time.perf_counter()
    lib = library()
    log(f"kernel build+load: {time.perf_counter() - t0:.3f} s ({lib.path.name} in "
        f"{lib.path.parent})")
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    copy_ms, copy_gbs = copy_bandwidth(torch)
    log(f"yardstick: torch device copy of 256 MB: {copy_ms:.4f} ms, {copy_gbs:.1f} GB/s")
    record = Records(copy_gbs)
    from gmres_tpu_torch.io.synth import convection_diffusion_2d

    t0 = time.perf_counter()
    A = convection_diffusion_2d(NX, beta=2.0)
    log(f"matrix: convection_diffusion_2d({NX}, beta=2.0) n={A.n_rows:,} "
        f"nnz={A.nnz:,} built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    convdiff_counts, x_single, walls_single, A_dev = convdiff_path(torch, record, A)
    t1 = time.perf_counter()
    mesh3d_counts, mesh, mesh_dev, mesh_x = mesh3d_path(torch, record)
    t2 = time.perf_counter()
    ilu_counts = convdiff_ilu_path(torch, record, A, A_dev)
    t2b = time.perf_counter()
    bf16ilu_counts = convdiff_bf16ilu_path(torch, A, A_dev)
    t3 = time.perf_counter()
    mgs_counts = convdiff_mgs_path(torch, record, A, A_dev, copy_gbs)
    t4 = time.perf_counter()
    df64_counts = convdiff_df64_path(torch, record, A, A_dev)
    t5 = time.perf_counter()
    dist_counts, dist_forms, dist_clis, cli_tmp, a_path, write_seconds = convdiff_dist_path(
        torch, record, A, A_dev, x_single, walls_single, mesh, mesh_x)
    t6 = time.perf_counter()
    cb_counts, form_counts = convdiff_cb_path(torch, record, A, A_dev, mesh, mesh_dev)
    del mesh, mesh_dev
    t7 = time.perf_counter()
    cli_counts, sweep_rows = cli_path(torch, A, cli_tmp, a_path, write_seconds, dist_clis)
    t8 = time.perf_counter()
    batched_counts, lane_launches = batched_path(torch, record, A, A_dev, sweep_rows)
    del A_dev
    log(f"path seconds: convdiff {t1 - t0:.1f}, mesh3d {t2 - t1:.1f}, "
        f"convdiff-ilu {t2b - t2:.1f}, convdiff-bf16ilu {t3 - t2b:.1f}, "
        f"convdiff-mgs {t4 - t3:.1f}, "
        f"convdiff-df64 {t5 - t4:.1f}, convdiff-dist {t6 - t5:.1f}, "
        f"convdiff-cb {t7 - t6:.1f}, cli {t8 - t7:.1f}, batched {time.perf_counter() - t8:.1f}")
    path_counts = (convdiff_counts, mesh3d_counts, ilu_counts, bf16ilu_counts, mgs_counts,
                   cb_counts, cli_counts, batched_counts)
    require(all(c[k] == 0 for c in path_counts for k in DF64_KERNELS),
            f"K8-K11 launched on the df64 and distributed paths only ({path_counts})")
    path_counts += (df64_counts,)
    require(all(c[k] == 0 for c in path_counts for k in DIST_KERNELS),
            f"K12 launched on the distributed path only ({path_counts})")
    require(dist_counts["dia_spmv_df64"] == 0,
            f"the distributed path launched no K8 ({dist_counts})")
    path_counts += (dist_counts,)
    counts = {k: sum(c[k] for c in path_counts) for k in kernel_wrappers()}
    require(all(v > 0 for v in counts.values()), f"every kernel launched on some path ({counts})")
    records = record.records
    path_forms = cb_forms()[2]
    # K5's rank form: its launches on the ranks of both distributed parts
    rank_launches = dist_forms[("sell_residual", "f64_rank")]

    # kernel -> (source, the TPU kernels' pallas_calls it replaces); the
    # JSON numbers are the fp32 variant (the mixed inner loop; for the
    # residual modes the fp64 residual with its fp32-demoted norm; for K7,
    # K2x2 and K3 plain the 31-row basis) and for K8-K11 the df64 variant
    # (31 rows), for K12 the interior block, the other variants alongside;
    # launches are summed over the eight paths' solves (the distributed one's
    # over its ranks), the cli phase's entry-point runs and the batched
    # solves; a dtype form's variant (bf16_f32, f32_f64, bf16_bf16 and K4's)
    # carries its launches on the convdiff-cb path, a lane form's (K1's
    # <dtype>_lanes<s>, its residual mode's <norm dtype>_lanes<s>) in the
    # batched solves
    sources = {
        "dia_spmv": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                     "gmres_tpu/ops/pallas/spmv_kernel.py:88"),
        "dia_residual": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                         "gmres_tpu/ops/pallas/df64_kernel.py:243"),
        "sell_spmv": ("gmres_tpu_torch/csrc/sell_spmv.cu",
                      "gmres_tpu/ops/pallas/sell_kernel.py:272,218"),
        "sell_residual": ("gmres_tpu_torch/csrc/sell_spmv.cu",
                          "gmres_tpu/ops/pallas/sell_kernel.py:452,490"),
        "basis_gram": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                       "gmres_tpu/ops/pallas/orth_kernel.py:59"),
        "basis_update_gram": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                              "gmres_tpu/ops/pallas/orth_kernel.py:171"),
        "basis_update_sumsq": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                               "gmres_tpu/ops/pallas/orth_kernel.py:216"),
        "basis_axpy": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                       "gmres_tpu/ops/pallas/df64_kernel.py:295"),
        "ilu_trisolve_fused": ("gmres_tpu_torch/csrc/ilu_trisolve.cu",
                               "gmres_tpu/ops/pallas/trisolve_kernel.py:213"),
        "ilu_trisolve_segmented": ("gmres_tpu_torch/csrc/ilu_trisolve.cu",
                                   "gmres_tpu/ops/pallas/trisolve_kernel.py:155"),
        "basis_mgs": ("gmres_tpu_torch/csrc/basis_mgs.cu",
                      "gmres_tpu/ops/pallas/orth_kernel.py:381"),
        "basis_gram2": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                        "gmres_tpu/ops/pallas/orth_kernel.py:102"),
        "basis_update": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                         "gmres_tpu/ops/pallas/orth_kernel.py:129"),
        "dia_spmv_df64": ("gmres_tpu_torch/csrc/df64_spmv.cu",
                          "gmres_tpu/ops/pallas/df64_kernel.py:141"),
        "df_gram": ("gmres_tpu_torch/csrc/df64_sweep.cu",
                    "gmres_tpu/ops/pallas/df64_kernel.py:559"),
        "df_update_gram": ("gmres_tpu_torch/csrc/df64_sweep.cu",
                           "gmres_tpu/ops/pallas/df64_kernel.py:602"),
        "df_update_sumsq": ("gmres_tpu_torch/csrc/df64_sweep.cu",
                            "gmres_tpu/ops/pallas/df64_kernel.py:656"),
        "dia_spmv_halo": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                          "gmres_tpu/ops/pallas/spmv_kernel.py:88"),
        "dia_residual_halo": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                              "gmres_tpu/ops/pallas/df64_kernel.py:243"),
    }
    require(set(sources) == set(kernel_wrappers()), "every kernel has a JSON entry")
    kernels = []
    for name, (src, replaces) in sources.items():
        rec = records[name]
        main = "df64" if name in DF64_KERNELS else "float32"
        main_rec = rec[main]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "dtype": main,
            "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
            "gb_per_s": main_rec["gb_per_s"], "copy_gb_per_s": copy_gbs,
            "variants": {k: (dict(v, launches=form_counts[name].get(k, 0))
                             if k in path_forms.get(name, ()) else
                             dict(v, launches=lane_launches[(name, k)]) if "_lanes" in k else
                             dict(v, launches=rank_launches) if " rank" in k else v)
                         for k, v in rec.items() if k != main},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
