#!/usr/bin/env python3
"""Drive the merge_spmv_tpu_torch main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero and prints no
"ok" line):

1. build   — compile the package's CUDA sources with nvcc (sm_90a), one
             nvcc per source, all started together; print the seconds, the
             compiler's register report, and the tile kernel's registers,
             dynamic shared memory and resident blocks per SM at the
             default tile size, in float32 and float64, for each gather
             policy (ops/plan.py::POLICIES); the same for the multi-RHS
             tile kernel K1m (csrc/merge_csrmm.cu) at k = 4, 8, 32 and
             64, with its rows in flight a walker and its carveout, and the
             registers and spills of its <float, 4, true, 2>, <float, 4,
             true, 8> and <float, 4, true, 16> instantiations (k = 8, 32
             and 64); fails if any K1 or K1m instantiation spills.
   stream  — utils/device.py::measure_stream_bandwidth (the STREAM triad
             over 256 MB arrays, CUDA-graph replays) beside the published
             3,350 GB/s.
2. cases   — the merge kernels against their plain PyTorch versions and the
             sequential gold SpMV on the corner cases of the JAX package's
             tests (tile-spanning hub row, empty rows, duplicates, a row
             ending on a tile boundary, alpha/beta, signed values, nnz = 0,
             one column), and two cases of the fused kernel's tail (one
             row over every run, G above the tail block's threads; long
             rows whose carries meet at a chunk's edge), in float32, then
             float64 and bfloat16 on two cases; the tail cases also two
             calls and the two kernels bitwise equal.
3. determinism — two calls on the same input give the same bits.
4. main    — the user path at full size: grid3d(100) (1M rows, 5.94M
             nonzeros, float32) through build_operator / op(x) /
             op(x, y_in, alpha, beta) / op.mm(X), verified against gold,
             with the launch counters read around exactly that run (one
             fused tile-kernel launch per op(x), no separate fix-up, and
             one K1m launch for op.mm's four columns), K1m against its
             plain version on that X, and two op(x) calls bitwise equal; the
             fused kernel's launch (its persistent blocks G, the tiles
             each runs, the stages and the shared memory: its last block
             sums G carry pairs); then op(x) timed (device time from
             CUDA-graph replay, and per eager call), op(x) through the
             fused kernel against merge_tile + carry_fixup at the same runs
             (bitwise equal; device and eager, in turns), eager op(x)
             broken down by the host's clock (operator layers, operand
             checks, allocation, device context, ctypes launch) and eager
             op(x) through the wrappers' host path against the one they
             had before (a device context and a Stream object per call),
             in turns, each
             kernel timed beside its plain version, its bound and its
             PyTorch library counterpart (cuSPARSE for the tile kernels,
             index_add_ for the fix-up), the kernels and cuSPARSE also
             with a cold L2 (a 256 MB write before each launch, its own
             time subtracted) and the fused kernel in float64.  Kernel and
             library times are CUDA-graph replays; the plain versions
             synchronise inside, so they are timed eagerly.  Then
             grid3d(100) through build_operator(dtype="bfloat16"),
             verified and timed beside float32, and the fp64 long row:
             one 4,000,000-nonzero float64 row through K1, its relative
             error against a float64 NumPy dot held to 2 gamma_n and to
             64 * 2^-24 (the card's twin of tests/test_fp64_audit.py:70).
5. dia cases — the DIA kernel (K3) against its plain version and gold on
             the JAX package's DIA test shapes (tests/test_dia.py): the
             grid3d/grid2d stencils, the rectangular case, duplicates, the
             stencil plus scattered extras, alpha/beta, float64, bfloat16,
             and two bitwise-equal calls.
6. dia main — grid3d(100) float32 (the main phase's matrix: 6 diagonals,
             no leftover) through build_dia_operator / op(x) /
             op(x, y_in, 2, 1) / op.mm(X[:, :4]) (one K3m launch, K3m
             against its plain version), verified against gold with the
             launch counter read around exactly that run; then
             the same matrix with 1% scattered extras, so the leftover runs
             the fused merge kernel at size and both counters move (and
             the leftover through the two kernels, timed beside it).
             op(x) timed (CUDA graph and eager), the kernel beside its
             plain version, its bound and cuSPARSE on the same matrix; the
             DIA kernel also with a cold L2.
7. skew    — the uniform / power-law pair at 2^19 rows and 4,194,304
             nonzeros sharing one column stream (bench.py:179-221):
             verified and timed; the per-nonzero ratio is the paper's claim
             that the time does not depend on row-length skew, and fails
             the run below SKEW_RATIO_MIN; the two-kernel path timed too.
             Then wheel_1m (one hub row over a third of the runs):
             verified, K1 beside cuSPARSE, and the tail's share of the
             fused time (against the tile kernel alone and the two kernels
             at the same runs); and banded_n1024k_bw128_d5 at full size:
             the policy and tile the plan picks, K1 under "stream" and
             under "l1" at both its tiles, beside cuSPARSE.
   headline — python -m merge_spmv_tpu_torch.bench.headline as a
             subprocess: its JSON line (bench.py's keys: the grid3d(100)
             merge headline, the DIA block, the controlled and natural
             skew pairs, the circuit-class quarter and vs_baseline) printed
             on a line of its own; every key present, no *_error key.
   solvers — the regularised grid3d(100) Laplacian L = D - A + I (7
             diagonals): CG through merge and through DIA, Jacobi, power
             iteration, and BiCGSTAB on L with its lower off-diagonals
             halved (CG's vector work through csrc/cg_step.cu's three
             fused kernels, one launch each an iteration), each run with
             its blocks replayed as a CUDA graph and
             again eagerly (bitwise equal; the launch counters per
             iteration from the eager run), checked in float64 with SciPy
             (relative residual, or the eigenvalue against L's analytic
             largest and its vector's Rayleigh quotient); iterations,
             device time per iteration beside op(x), launches per
             iteration and host reads per solve.  Then CG's fused step on
             HPCG's 27-point matrix at 104^3 in float64 (the hpcg_104
             cell's): steps against the torch step from one state (8 ulps
             of each norm, k exact), a fused and a torch solve with the
             same iterations, and each fused kernel's device time in the
             solve's own sequence (the profiler over replayed blocks)
             beside its HBM bytes bound and the torch step's vector work;
             they join the kernels line.  Then HPCG's preconditioned CG
             at the hpcg_104_mg.pcg cell's shapes (multigrid_report):
             build_multigrid on that matrix; at every level the V-cycle's
             colour step (symgs_update, each colour: product and update in
             one launch) within COLOUR_ULPS of its plain route, and
             mg_restrict and mg_prolong bit-equal to their plain versions,
             through the launchers the V-cycle binds; 4 fused PCG steps
             (pcg_pap, pcg_update, pcg_rz, cg_direction with z) against
             pcg_torch_step from one state; the cell's set (50
             iterations, blocks of 16) with every launch counter reset
             just before: the host's counts by level and kind against
             the V-cycles it enqueued, the card's (65 V-cycles, no K1
             right before a colour step) from the profiler, and each kernel's
             device ms by level in that set beside its bytes bound, the
             kernel and its plain version alone; they join the kernels
             line.
8. driver  — merge_spmv_tpu_torch.bench.driver.run_benchmark on grid2d(1000)
             with the scipy, xla (cuSPARSE), merge, dia, split and hotcold
             backends; every backend must verify.
   gather  — the gather-rate probe (tools/gather_rate.py): the kernel
             against its plain version, then random 4-byte reads over x of
             22 MB and 4 MB (the circuit and kron classes' x) and of 128
             and 32 KB: the L2 sector rate behind each class's gather
             bound.
9. split main — the circuit5M class at full size (make_circuit_like(
             5,558,326, 59,524,291), float32): suggest_backend's record; merge
             op(x) as the baseline, with its gather policy and launch, timed
             on the device and eagerly, the fused kernel alone warm and with
             a cold L2 under both policies in turns, against its plain
             version, beside cuSPARSE on the same timer, the bytes bound and
             the gather bound; build_split_operator_device (16 quantile
             bands) with its setup and stage times; op(x),
             op(x, y_in, 1.5, -0.5) and op.mm(X[:, :2]) verified against gold
             with the launch counter read around exactly that run (one fused
             launch per op(x), one K1m launch for op.mm) and two op(x) calls bitwise
             equal; op(x) timed (CUDA graph and eager) beside merge op(x),
             cuSPARSE and the bytes bound of each; the host builder
             (geometric (8, 32) edges) full-row and compact, verified and
             timed; build_suggested on the matrix.
   distributed — two ranks of parallel/mp_worker.py on this card over
             gloo: grid3d(100) (halo mode, the split path: the interior K1
             launched before the halo exchange, the boundary items through
             K1 after it) and the circuit5M class (replicate mode), made
             once here and handed over as .npy files; every window
             verified against gold and against the unsplit call, two calls
             bitwise equal, both ranks PASS; per rank on grid3d(100) its
             boundary items, 2 K1 launches a call, the split and unsplit
             calls' times and ``overlap_scheduled`` from its timeline;
             each rank's K1 times (CUDA graph) and whole call (eager).
10. hotcold main — the kron class (R-MAT scale 20, 50M generated nonzeros,
             float32): suggest_backend's record; merge op(x) reported as on
             the circuit class; build_hotcold_operator with
             its hot windows and hot/cold nonzeros; op(x) and the alpha/beta
             call verified with two fused launches per op(x); timed beside
             merge op(x) and cuSPARSE; build_suggested on the matrix.
   large tools — the circuit- and kron-class benchmark tools
             (tools/bench_large.py, bench_hotcold.py, split_compact_bench.py)
             through their run() on the two matrices above and the circuit
             class's quarter: merge op(x) beside cuSPARSE, the host
             quantile split at B = 16 (the records' own runs sweep 8, 16
             and 32), the geometric (8, 32) split, the device-built split
             (built twice), hot/cold or its refusal; hot/cold's A/B on the
             kron class; the compact split at B = 16 with the stacked
             kernel and the re-expansion timed alone, beside the plain
             stack.  One line per tool; fails on a JAX key missing, an
             entry not verified or an error key (bench/measure.py::
             record_faults), or no K1 launch in the phase.
   pagerank — PageRank through K1 on the kron class's column-stochastic
             transpose (pagerank_operator in float32), stopped at an L1
             step of 1e-6, against a float64 SciPy run of the same
             iterations (L1 distance).
11. router — build_suggested on grid3d(100) and the local-uniform fixture of
             tests/test_suggest.py:48-57 (and the two matrices above): each
             pick verified and timed against merge op(x).
12. autotune — build_operator(grid3d(100), autotune=True) with the cache in
             a temporary file: each candidate's time, then a second build
             that reads the cache and times nothing (the tuner's counter).
13. probe   — the op-class probe (P1): each class's kernel against its
             plain version at a small size, the select kernel's timed loop
             counted in its SASS, then every class at the full size (the
             TPU probe's grid 4096 x unroll 64 x 8 chains) with its rates and
             bounds (operations; shared memory, warp shuffles or instruction
             issue where they bind), the plain version timed and compared at
             that size too.
   ingest  — the circuit5M class at the headline's quarter scale
             (14,178,457 nonzeros) written as .mtx by the native writer,
             parsed by the native library (csrc/market_io.cpp, built by g++)
             and by NumPy, and turned into CSR both ways: the arrays
             bit-equal, the four host times and the file's size; fails if
             the native library is unavailable.
   corpus  — the 25 files of the mini corpus (tools/make_corpus.py) and one
             full-size matrix per generator family of the stats corpus
             (CORPUS_FULL, tools/make_corpus_stats.py) through
             tools/eval_corpus.py with the merge (K1) and xla (cuSPARSE)
             backends, one CLI process per file, every row verified against
             gold; each row's policy, K1 launches and both times, and
             tools/corpus_stats.py's statistics; fails on any ERROR,
             TIMEOUT or FAIL row.
   baseline — the north-star configurations that fit a smoke run, at
             their published sizes, through the port's benchmark tools'
             own functions (tools/bench_{baseline_configs,spmm,skew,
             multichip}.py): cant_class in float64 (3,996,864 nonzeros),
             webbase_1M_class, op.mm with k = 8 and 32 on the cant and
             pdb1HYS classes (one K1m launch, beside method="column", K1
             once per column, and cuSPARSE SpMM; K1m alone warm and cold
             against its plain version, its gather bound from the
             row-gather probe), the skew trio at 2^20 x 8, bench_spmm on
             grid3d(60) with k = 32 (K1m, K3m and both column loops), and
             weak scaling over 1, 2 and 4 gloo ranks sharing the card at
             2^17 rows a rank.
             Every matrix verified against gold before it is timed, beside
             cuSPARSE; K1 on each SpMV config (and each SpMM matrix's
             first column) also against its plain version within the
             backward-error bound |A| |x| (bench/measure.py::card_spmv);
             cant_class's float64 result, against gold and against the
             plain version, also within 2 gamma_n |A| |x| per row
             (bench/measure.py::fp64_bound).  Launches counted from 0
             around the phase (the ranks' from their reports), around
             cant_class's own run for its kernels-line entry, and around
             the SpMM runs for K1m's and K3m's.
   fastrp k1m — K1m at the FastRP cell's width (fastrp_k1m_report): the
             kron_g500_logn21_sym graph (182,082,942 nonzeros) through
             transition_operator in float32 and op.mm on X [2^21, 256],
             four K1m launches and nothing else counted from 0 around the
             call; against merge_csrmm_plain within 2 gamma_n |P| |X| per
             entry, its largest difference in float32 ulps of |P| |X|;
             op.mm and K1m alone timed beside cuSPARSE SpMM, the plain
             version's time and the bytes bound.  Then FastRP's
             normalise-and-accumulate (fastrp_normalize_report): the
             main path, solvers.fastrp on that operator at the cell's
             weights, with the counters reset just before, makes one
             row_normalize launch and one "fused" step a product; then at
             the cell's N [2^21, 256] float32 in its three modes (the
             products' n(N); n(N) and E = w n(N); E += w n(N)) the kernel
             of csrc/row_normalize.cu, one launch a call, against the
             torch ops on the same N (n(N) and E within 8 float32 ulps of
             their scale), each timed with its bytes bound.
   pagerank cell — the graph500_24.pagerank cell's path (pagerank_report):
             pagerank_operator's transpose on a directed graph with
             dangling vertices (the generator's graph at scale 20, its
             links u -> v with u < v) equal to the sparse COO transpose of
             D^-1 A, bit for bit in float64, its columns summing to 1 or
             empty; then the cell's graph500-24 (the generator at the
             configuration's parameters, seed 0: its counts) through
             pagerank_operator in float64, P equal to A D^-1 bit for bit;
             K1 on P against its plain version within the backward-error
             bound and 2 gamma_n |P| |x| (bench/measure.py::card_spmv),
             timed beside cuSPARSE and the bytes bound; then the cell's
             job, solvers.pagerank(op, 0.85, tol=0, maxiter=10) with K1's
             counters reset just before: 16 fused launches, one host read,
             10 iterations, no graph captured, and its ranks within the
             cell's rank_err limit (L1) of models/pagerank_reference.py in
             float64, the float32 reference outside it.
14. the kernels line, nvidia-smi's name and power limit, and the last line.
"""

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

TILE_ITEMS_CASES = 1024   # the JAX package's kernel tests use 1024-item tiles
# uniform / power-law time per nonzero: below this, skew costs time
SKEW_RATIO_MIN = 0.9
HOST_CALLS = 200          # calls per host-clock sample of the eager breakdown
# the circuit5M class (tools/bench_large.py:90-91) and the kron class's
# generated nonzeros (tools/bench_hotcold.py:43-44), both at full size
CIRCUIT_ROWS, CIRCUIT_NNZ = 5_558_326, 59_524_291
KRON_NNZ = 50_000_000
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# solvers on the regularised grid3d(100) Laplacian: the true relative
# residual ||b - A x|| / ||b|| in float64 of a float32 solve stopped at
# tol 1e-6 (its recurrence residual) may drift above it, not past 10x
SOLVER_TOL, RESIDUAL_MAX = 1e-6, 1e-5
# power iteration: the eigenvalue within 1e-3 of L's largest (the JAX
# test's tolerance) and within 1e-5 of its vector's float64 Rayleigh
# quotient.  L's top eigenvalues are 2e-4 apart, so the Rayleigh quotient
# closes in as ~1/k: a tol below the float32 spacing at 13 (9.5e-7) stops
# the loop only where it stagnates, late enough for the 1e-3
EIG_REL_MAX, RAYLEIGH_REL_MAX = 1e-3, 1e-5
POWER_TOL, POWER_MAXITER = 1e-7, 5000
# CG's fused step (csrc/cg_step.cu) on HPCG's 27-point matrix at 104^3
# (1,124,864 rows, 29,791,000 nonzeros, float64): steps against the torch
# step from one state, each within 8 ulps of its value's norm (the card
# tests' bound); a fused and a torch solve to 1e-10 take the same
# iterations, their solutions within 1e-9 of each other (the benchmark's
# limit)
HPCG_WIDTH, HPCG_NNZ = 104, 29_791_000
FUSED_STEPS, FUSED_ULPS = 4, 8
FUSED_TOL, FUSED_SOLUTION_REL_MAX = 1e-10, 1e-9
# a fused kernel's vector passes of n values from HBM in CG's own sequence
# (p, ap; x and r read and written; p written), and those the step's earlier
# kernel leaves in the 50 MB L2 (cg_update's p and ap after cg_pap read
# them; cg_direction's r and p after cg_update)
FUSED_PASSES = {"cg_pap": (2, 0), "cg_update": (4, 2),
                "cg_direction": (1, 2)}
# HPCG's preconditioned CG (models/multigrid.py) on the hpcg_104_mg cell's
# hierarchy, float64: the V-cycle's three kernels bit-equal their plain
# versions (one subtraction, division or addition a value, correctly
# rounded on both sides); PCG's fused step against pcg_torch_step from one
# state, each value within PCG_ULPS of its norm (CG's bound; pcg_update,
# the largest, read 2.57 on an H100); the cell's set: 50 iterations in
# blocks of 16, so 64 steps launched and 65 V-cycles with the prologue's
PCG_ULPS = FUSED_ULPS
PCG_MAXITER, PCG_EVERY, PCG_STEPS = 50, 16, 64
# a PCG kernel's vector passes of n values from HBM in the solve's own
# sequence, and those from L2: pcg_update's p and ap after pcg_pap read
# them; cg_direction's z after pcg_rz read it.  The V-cycle between
# pcg_update and pcg_rz streams ~0.9 GB, so r, z and p come from HBM after
# it
PCG_PASSES = {"pcg_pap": (2, 0), "pcg_update": (4, 2), "pcg_rz": (2, 0),
              "cg_direction": (2, 1)}
# the V-cycle's grid transfers: bytes a row each touches (int32 index,
# values of 8 bytes): mg_restrict reads f2c, r and Axf and writes r_c and
# x_c; mg_prolong reads f2c, x_c and x and writes x.  A colour step's bound
# is spmv_bench/roofline_mg.py::symgs_bytes' count for its level
MG_ROW_BYTES = {"mg_restrict": 4 + 4 * 8, "mg_prolong": 4 + 3 * 8}
# the colour step (one launch: the colour's product and update) against its
# plain route (the colour operator's K1 product, then symgs_update_plain)
# on the same x and r: each row of x within COLOUR_ULPS unit roundoffs of
# (|A_c| |x| + |r|) / a_ii (the two sum a row's <= 27 products in other
# orders; tests/test_torch_multigrid.py's bound), x equal off the colour
COLOUR_ULPS = 16
# PageRank on the kron class: stopped at an L1 step of 1e-6, which float32
# reaches (its rounding floor over 1M ranks is ~1e-7); the L1 distance from
# a float64 run of the same iterations at most 1e-4 of the total mass 1
PAGERANK_TOL, PAGERANK_L1_MAX = 1e-6, 1e-4
LONG_ROW_NNZ = 4_000_000  # tests/test_fp64_audit.py:70
# K1m at the FastRP cell's shape (spmv_bench's kron_g500_logn21_sym.fastrp):
# its configuration, d = 256 columns (four 64-column launches a product),
# a seed of the cell's kind (above 2^31), and the columns a block of the
# plain version holds (its gathered products, 182M x 8 float32, ~6 GB)
FASTRP_CONFIG = os.path.join(REPO_DIR, "spmv_bench", "configs",
                             "kron_g500_logn21_sym.json")
FASTRP_K, FASTRP_SEED, FASTRP_PLAIN_COLS = 256, 2 ** 31 + 22, 8
# the cell's weights, and FastRP's normalise-and-accumulate in its three
# modes, one a product: (name, w, E given, store_n, passes of N's bytes over
# HBM: N read, N written, E written, E read)
FASTRP_WEIGHTS = (0.0, 1.0, 1.0)
FASTRP_NORMALIZE_MODES = (("n(N)", 0.0, False, True, 2),
                          ("n(N), E = w n(N)", 1.0, False, True, 3),
                          ("E += w n(N)", 1.0, True, False, 3))
FASTRP_NORMALIZE_ULPS = 8
# the graph500_24.pagerank cell's path (spmv_bench): its configuration,
# traffic and limits, the seed its configuration's counts are the
# generator's at, and the scale of the directed graph the transpose is
# checked on
PAGERANK_CONFIG = os.path.join(REPO_DIR, "spmv_bench", "configs",
                               "graph500_24.json")
PAGERANK_TRAFFIC = os.path.join(REPO_DIR, "spmv_bench", "traffic",
                                "pagerank.json")
PAGERANK_LIMITS = os.path.join(REPO_DIR, "spmv_bench", "limits",
                               "graph500_24.pagerank.json")
PAGERANK_SEED, PAGERANK_DIRECTED_SCALE, PAGERANK_JOBS = 0, 20, 5
# the corpus phase: one full-size matrix per generator family of the stats
# corpus (tools/make_corpus_stats.py), CoV 0 to the wheel, banded to global
# scatter, beside the 25 files of the mini corpus (tools/make_corpus.py)
CORPUS_FULL = ("grid2d_500", "grid3d_64", "banded_n256k_bw4096_d9",
               "plaw_n256k_a1p2", "plaw_n256k_a3p0", "uspread_262144",
               "wheel_1m", "dense_1000", "tridiag_512k", "hub_1024_f6",
               "tall_512k_x_4k", "wide_1k_x_512k", "empties_n1m_p146k",
               "blocks_4096", "kron_like_1m", "uglobal_512k")
CORPUS_FILES = 25 + len(CORPUS_FULL)
# the tail case whose long rows meet at pair 128 (a chunk's edge for the
# 128-thread blocks of TILE_ITEMS_CASES), at pair 172 (inside a 32-pair
# group) and at the sentinel, short rows between them
TAIL_EDGE_ROWS = [128 * TILE_ITEMS_CASES + 5, 44 * TILE_ITEMS_CASES + 7, 3,
                  0, 5, 90 * TILE_ITEMS_CASES, 1, 2 * TILE_ITEMS_CASES + 9]


class MergeDirect:
    """A merge operator's op(x) straight through the kernel wrappers, for
    the A/B timing: the fused kernel (``merge_csrmv``, op(x)'s route) or
    ``merge_tile`` then ``carry_fixup``, both at the fused kernel's runs so
    that the two give the same bits; the fused kernel counts on the
    operator's tickets.  Timed as an operator by ``chained_rate_ms``."""

    def __init__(self, K, op, fused, device):
        self.K, self.op, self.fused = K, op, fused
        self.plan, self.abs_row_sum_max = op.plan, op.abs_row_sum_max
        self.shape = op.shape
        self.policy = op.plan.policy
        self.run = K.launch_geometry(op.plan.num_tiles, op.plan.tile_items,
                                     op.values.dtype, device, fused=True,
                                     policy=self.policy).run_tiles

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0):
        o, K = self.op, self.K
        args = (o.values, o.col_indices, o.row_end_offsets, x, o.tile_rows,
                o.tile_nnz, o.plan.tile_items, y_in, alpha, beta)
        if self.fused:
            return K.merge_csrmv(*args, run_tiles=self.run,
                                 tickets=o.tickets, policy=self.policy)
        return K.carry_fixup(*K.merge_tile(*args, run_tiles=self.run,
                                           policy=self.policy), alpha)


class DiaDirect:
    """A DIA operator with a leftover, its op(x) as the DIA kernel and then
    the leftover's MergeDirect (fused or the two kernels)."""

    def __init__(self, K, DK, op, fused, device):
        self.DK, self.op = DK, op
        self.rest = MergeDirect(K, op.rest_op, fused, device)
        self.plan, self.abs_row_sum_max = op.plan, op.abs_row_sum_max
        self.shape = op.shape

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0):
        o = self.op
        y = self.DK.dia_matvec(o.vtab, x, o.offsets_t, o.num_rows,
                               o.num_cols, alpha)
        return self.rest(x, y, alpha, 1.0)


def tail_rows(lengths, n_cols=5000, seed=40):
    """A COO matrix with these row lengths, random columns and values."""
    import numpy as np

    from merge_spmv_tpu_torch.formats.coo import CooMatrix
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(len(lengths)), lengths)
    return CooMatrix(len(lengths), n_cols, rows,
                     rs.randint(0, n_cols, rows.size),
                     rs.uniform(-1, 1, rows.size))


def csr_bytes(rows, cols, nnz, vs=4):
    """Bytes y = A @ x moves over a CSR when each input is read once and
    each output written once: a value and a column index per nonzero, a
    row end and a y element per row, x once."""
    return nnz * (vs + 4) + rows * (4 + vs) + cols * vs


def k1_report(name, csr, op, x, K, GR, rates, peak_gbps, flush, flush_ms,
              cusparse):
    """The fused tile kernel on one matrix at full size, through ``op``'s
    own launch (its gather policy, runs and counter): against its plain
    version on the same inputs, warm and with a cold L2 (``flush`` written
    before each launch, ``flush_ms`` taken off) under the chosen policy
    and the other one in turns, beside cuSPARSE (``cusparse``, a callable)
    on the same timer, the bytes bound (each input read once, each output
    written once) and the gather bound (the distinct sectors of each warp
    request at the probe's L2 sector rate for an x of this size, plus the
    streams at the HBM peak).  Prints one line; returns the kernels-line
    entry and the numbers."""
    import torch

    from merge_spmv_tpu_torch.ops.csrmv_torch import row_ids_from_offsets
    from merge_spmv_tpu_torch.ops.plan import POLICIES
    from merge_spmv_tpu_torch.utils.compare import compare_results
    from merge_spmv_tpu_torch.utils.timers import event_ms
    plan, dev = op.plan, op.device
    T, n, nnz = plan.tile_items, csr.num_rows, csr.num_nonzeros
    args = (op.values, op.col_indices, op.row_end_offsets, x, op.tile_rows,
            op.tile_nnz, T)
    geo = {p: K.launch_geometry(plan.num_tiles, T, torch.float32, dev,
                                fused=True, policy=p) for p in POLICIES}
    chosen = plan.policy
    other = next(p for p in POLICIES if p != chosen)
    y = K.merge_csrmv(*args, tickets=op.tickets, policy=chosen)
    yp = K.merge_csrmv_plain(*args, run_tiles=geo[chosen].run_tiles)
    err = float((y - yp).abs().max())
    # |A| |x|, the scale of the two versions' rounding
    rows = row_ids_from_offsets(op.row_end_offsets, nnz)
    bound = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, rows, op.values.abs().double()
        * x.abs().double()[op.col_indices.long()])
    ok = compare_results(y.cpu().numpy(), yp.cpu().numpy(), verbose=False,
                         abs_bound=bound.cpu().numpy()) is None
    plain_ms = event_ms(lambda: K.merge_csrmv_plain(
        *args, run_tiles=geo[chosen].run_tiles), iters=3, reps=2,
        graph=False)
    ms = {chosen: [], other: []}
    cold = {chosen: [], other: []}
    for p in (chosen, other, other, chosen):
        ms[p].append(event_ms(lambda: K.merge_csrmv(
            *args, tickets=op.tickets, policy=p), iters=20))
        cold[p].append(event_ms(lambda: (flush.fill_(1.0), K.merge_csrmv(
            *args, tickets=op.tickets, policy=p)), iters=10) - flush_ms)
    lib_ms = event_ms(cusparse, iters=20)
    lib_cold = event_ms(lambda: (flush.fill_(1.0), cusparse()),
                        iters=10) - flush_ms
    coord_bytes = 2 * (plan.num_tiles + 1) * 4
    streams = nnz * 8 + n * 4 + n * 4 + coord_bytes
    fused_bytes = streams + csr.num_cols * 4
    bytes_bound = fused_bytes / peak_gbps / 1e6
    sectors = GR.warp_sectors(op.col_indices)
    probe = min(rates.values(), key=lambda r: abs(r["x_bytes"]
                                                  - csr.num_cols * 4))
    gather_bound = GR.gather_bound_ms(sectors, streams,
                                      probe["sector_rate_gbps"], peak_gbps)
    best = {p: min(v) for p, v in ms.items()}
    best_cold = {p: min(v) for p, v in cold.items()}
    g = geo[chosen]
    print(f"{name} K1: policy {chosen} ({plan.describe()}), launch G = "
          f"{g.grid} blocks of {g.threads} threads ({g.blocks_per_sm} per "
          f"SM), {g.run_tiles} tiles per run over {plan.num_tiles} tiles; "
          f"fused kernel warm {best[chosen]:.4f} ms ({other}: "
          f"{best[other]:.4f}; in turns {[round(v, 5) for v in ms[chosen]]}"
          f" vs {[round(v, 5) for v in ms[other]]}), cold L2 "
          f"{best_cold[chosen]:.4f} ({other}: {best_cold[other]:.4f}); "
          f"cuSPARSE {lib_ms:.4f} warm, {lib_cold:.4f} cold; fused / "
          f"cuSPARSE {best[chosen] / lib_ms:.3f} warm, "
          f"{best_cold[chosen] / lib_cold:.3f} cold; bytes bound "
          f"{bytes_bound:.4f} ms for {fused_bytes} B "
          f"({100 * bytes_bound / best[chosen]:.1f}%); gather bound "
          f"{gather_bound:.4f} ms ({sectors} sectors, "
          f"{sectors / max(nnz, 1):.3f} per nonzero, at the "
          f"{probe['x_bytes']} B probe's {probe['sector_rate_gbps']:.0f} "
          f"GB/s; {100 * gather_bound / best[chosen]:.1f}%); plain "
          f"{plain_ms:.2f} ms, kernel vs plain max|err| {err:.3e} ok={ok}")
    entry = {"name": f"merge_tile_fused@{name}", "route": "cuda",
             "source": "merge_spmv_tpu_torch/csrc/merge_csrmv.cu",
             "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:150",
             "launches": 0, "max_abs_err": err, "ms": best[chosen],
             "plain_ms": plain_ms, "bound_ms": bytes_bound,
             "bound_by": "bytes", "library_ms": lib_ms, "main_path": True,
             "policy": chosen, "cold_ms": best_cold[chosen],
             "gather_bound_ms": gather_bound}
    return entry, ok


def verified(got, csr, x, y_in=None, alpha=1.0, beta=0.0):
    """``got`` (on the card) is finite, of the matrix's row count, and
    agrees with the gold SpMV within the backward-error bound."""
    import torch

    from merge_spmv_tpu_torch.utils.compare import compare_results
    if tuple(got.shape) != (csr.num_rows,) or not bool(
            torch.isfinite(got).all()):
        return False
    return compare_results(
        got.cpu().numpy(), csr.spmv_gold(x, y_in, alpha, beta),
        verbose=False,
        abs_bound=csr.spmv_abs_bound(x, y_in, alpha, beta)) is None


@contextlib.contextmanager
def wrapper_host_path(modules, before):
    """With ``before``, the kernel wrappers of ``modules`` make each launch
    the way they did before: inside ``torch.cuda.device`` and with a
    ``torch.cuda.Stream`` object looked up per call; otherwise as they do
    now (the context only off the current device, the raw stream handle).
    For a same-run A/B of the eager host cost."""
    import torch
    saved = [(m, m.device_context, m.raw_stream) for m in modules]
    if before:
        for m in modules:
            m.device_context = torch.cuda.device
            m.raw_stream = lambda d: torch.cuda.current_stream(d).cuda_stream
    try:
        yield
    finally:
        for m, ctx, stream in saved:
            m.device_context, m.raw_stream = ctx, stream


def host_us(fn, sync):
    """Host microseconds per ``fn()`` call: HOST_CALLS calls by the host's
    clock, the device drained before each sample, minimum of 5 samples."""
    best = float("inf")
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, time.perf_counter() - t0)
    sync()
    return best / HOST_CALLS * 1e6


def regularised_laplacian(width):
    """L = D - A + I of the width^3 grid (tests/test_solvers.py:17-28),
    built without densifying: -1 off the diagonal, the degree + 1 on it."""
    import numpy as np

    from merge_spmv_tpu_torch.formats.coo import CooMatrix
    from merge_spmv_tpu_torch.formats.csr import CsrMatrix
    g = CooMatrix.grid3d(width)
    n = g.num_rows
    deg = np.bincount(g.rows, minlength=n).astype(np.float64)
    diag = np.arange(n)
    return CsrMatrix.from_coo(CooMatrix(
        n, n, np.r_[g.rows, diag], np.r_[g.cols, diag],
        np.r_[-g.vals, deg + 1.0])).astype(np.float32)


def scipy_csr(csr):
    """The matrix in float64 for SciPy (the host references)."""
    import numpy as np
    import scipy.sparse as sp
    return sp.csr_matrix((csr.values.astype(np.float64), csr.col_indices,
                          csr.row_offsets), shape=(csr.num_rows,
                                                   csr.num_cols))


def run_solver(name, fn, mods, init_launches, check_every=16):
    """``fn(graph)`` -> (tensors..., info) on the card: once with the
    default (blocks replayed as a CUDA graph), timed by the host clock,
    then with every block eager, for the launch counters per iteration
    (a captured launch counts once, at capture) and the bits of the
    replay.  ``init_launches`` are the launches before the loop.
    Returns (graph run's outputs, report dict)."""
    import torch
    for m in mods:
        m.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(None)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counted = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
    for m in mods:
        m.reset_launches()
    eager = fn(False)
    torch.cuda.synchronize()
    eager_counts = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
    info = out[-1]
    steps = eager[-1].host_reads * check_every
    per_iter = {k: (v - init_launches.get(k, 0)) / steps
                for k, v in eager_counts.items()}
    same = all(torch.equal(a, b) for a, b in zip(out[:-1], eager[:-1])) \
        and int(info.iterations) == int(eager[-1].iterations)
    return out, {"name": name, "iterations": int(info.iterations),
                 "host_reads": info.host_reads, "step_ms": info.step_ms,
                 "wall_ms": wall_ms, "launches": counted,
                 "launches_per_iteration": per_iter,
                 "graph_equals_eager": same}


def solver_line(rep, op_ms, check):
    step = ("none replayed" if rep["step_ms"] is None
            else f"{rep['step_ms']:.4f} ms per iteration on the device "
                 f"({rep['step_ms'] / op_ms:.2f}x op(x))")
    return (f"solver {rep['name']}: {rep['iterations']} iterations, {step}, "
            f"op(x) {op_ms:.4f} ms; launches per iteration "
            f"{rep['launches_per_iteration']} (counted in the graph run: "
            f"{rep['launches']}); {rep['host_reads']} host reads; "
            f"{rep['wall_ms']:.1f} ms by the host clock; graph replay "
            f"bitwise equal to the eager loop {rep['graph_equals_eager']}; "
            f"{check}")


def stencil27(width):
    """HPCG's matrix (GenerateProblem): the 27-point stencil on the width^3
    grid, 26 on the diagonal and -1 to every neighbour inside the grid,
    columns in increasing order, float64 (the hpcg_104 cell's matrix)."""
    import itertools

    import numpy as np

    from merge_spmv_tpu_torch.formats.csr import CsrMatrix
    n = width ** 3
    idx = np.arange(n, dtype=np.int64)
    at = (idx % width, idx // width % width, idx // (width * width))
    offsets = list(itertools.product((-1, 0, 1), repeat=3))   # (dz, dy, dx)
    cols = np.empty((n, len(offsets)), np.int64)
    valid = np.ones((n, len(offsets)), bool)
    for j, off in enumerate(offsets):
        cols[:, j] = idx + (off[0] * width + off[1]) * width + off[2]
        for a, d in zip(at, off[::-1]):
            valid[:, j] &= (a + d >= 0) & (a + d < width)
    vals = np.where([off == (0, 0, 0) for off in offsets], 26.0, -1.0)
    return CsrMatrix(n, n, np.r_[0, np.cumsum(valid.sum(1))], cols[valid],
                     np.broadcast_to(vals, valid.shape)[valid])


def kernel_device_ms(prof, names):
    """Each named kernel's device times (ms) in a ``torch.profiler`` run,
    by a part of its name."""
    times = {name: [] for name in names}
    for e in prof.profiler.kineto_results.events():
        for name in names:
            if name in e.name():
                times[name].append(e.duration_ns() * 1e-6
                                   if hasattr(e, "duration_ns")
                                   else e.duration_us() * 1e-3)
    return times


def fused_cg_report(SV, CG, peak_gbps):
    """CG's fused step (models/cg_cuda.py) on the hpcg_104 cell's matrix in
    float64.  FUSED_STEPS steps from x = 0, r = p = b, each fused step
    beside ``cg_torch_step`` from the same state (the torch state is copied
    into the fused one after each): alpha (cg_pap), x, r and rs
    (cg_update) and p (cg_direction) within FUSED_ULPS of their norms, k
    exact.  A fused and a torch solve to FUSED_TOL: the same iterations.
    Then a solve of 64 active steps each way under ``torch.profiler`` (the
    cell's sequence: blocks of 16, replayed after the first, K1 between
    steps, one more K1 in the prologue): each fused kernel's device ms a
    launch, its HBM bytes bound (FUSED_PASSES), and the torch step's vector
    work (its step less K1).
    Returns (ok, line, report)."""
    from unittest import mock

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from merge_spmv_tpu_torch.ops.operator import build_operator
    csr = stencil27(HPCG_WIDTH)
    op = build_operator(csr, dtype="float64")
    n, dev, f64 = csr.num_rows, torch.device("cuda"), torch.float64
    b = torch.from_numpy(np.random.RandomState(104).uniform(-1, 1, n)).to(
        dev)
    fused_state = [torch.zeros_like(b), b.clone(), b.clone(),
                   torch.sum(b * b), torch.zeros((), dtype=f64, device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev)]
    torch_state = [t.clone() for t in fused_state]
    step = CG.FusedCgStep(*fused_state, maxiter=FUSED_STEPS)
    eps = torch.finfo(f64).eps

    def err(got, want):
        d = float((got - want).abs().max())
        return d, d / (eps * float(torch.linalg.vector_norm(want)))

    errs = {name: [0.0, 0.0] for name in FUSED_PASSES}   # abs, ulps of norm
    k_exact = True
    for i in range(FUSED_STEPS):
        p, rs = torch_state[2], torch_state[3]
        alpha = rs / torch.sum(p * op(p))       # the torch step's alpha
        step.step(op(fused_state[2]))
        SV.cg_torch_step(op, *torch_state, maxiter=FUSED_STEPS)
        got = {"cg_pap": [(step.work[0], alpha)],
               "cg_update": [(fused_state[j], torch_state[j])
                             for j in (0, 1, 3)],       # x, r, rs
               "cg_direction": [(fused_state[2], torch_state[2])]}
        for name, pairs in got.items():
            for g, w in pairs:
                a, u = err(g, w)
                errs[name] = [max(errs[name][0], a), max(errs[name][1], u)]
        k_exact &= int(fused_state[5]) == int(torch_state[5]) == i + 1
        for f, t in zip(fused_state, torch_state):
            f.copy_(t)
    del step, fused_state, torch_state

    def solve(tol, maxiter):
        out = SV.conjugate_gradient(op, b, tol=tol, maxiter=maxiter,
                                    check_every=16)
        torch.cuda.synchronize()
        return out

    def torch_step():
        return mock.patch.object(CG, "takes", lambda device, dtype: False)

    x_f, info_f = solve(FUSED_TOL, 1000)
    with torch_step():
        x_t, info_t = solve(FUSED_TOL, 1000)
    iters = (int(info_f.iterations), int(info_t.iterations))
    sol_rel = float((x_f - x_t).abs().max() / x_t.abs().max())
    del x_f, x_t

    names = ("merge_tile_kernel", *FUSED_PASSES)
    steps, timed = 64, {}
    for side in ("fused", "torch"):
        with torch_step() if side == "torch" else contextlib.nullcontext():
            solve(0.0, steps)                   # warm: capture, first use
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, info = solve(0.0, steps)
        times = kernel_device_ms(prof, names)
        timed[side] = {"step_ms": info.step_ms,
                       "k1_ms": float(np.mean(times["merge_tile_kernel"])),
                       "counts": {k: len(v) for k, v in times.items()},
                       "kernel_ms": {k: float(np.mean(v)) if v else None
                                     for k, v in times.items()}}
        timed[side]["vector_ms"] = (timed[side]["step_ms"]
                                    - timed[side]["k1_ms"])
    fused_t, torch_t = timed["fused"], timed["torch"]
    nbytes = n * b.element_size()
    kernels = {name: {"ms": fused_t["kernel_ms"][name],
                      "launches": fused_t["counts"][name],
                      "max_abs_err": errs[name][0],
                      "ulps_of_norm": errs[name][1],
                      "hbm_passes": hbm, "l2_passes": l2,
                      "bound_ms": hbm * nbytes / peak_gbps / 1e6}
               for name, (hbm, l2) in FUSED_PASSES.items()}
    ok = (csr.num_nonzeros == HPCG_NNZ and k_exact
          and all(e[1] <= FUSED_ULPS for e in errs.values())
          and iters[0] == iters[1] < 1000
          and sol_rel <= FUSED_SOLUTION_REL_MAX
          and fused_t["counts"] == {**{k: steps for k in FUSED_PASSES},
                                    "merge_tile_kernel": steps + 1}
          and torch_t["counts"] == {**{k: 0 for k in FUSED_PASSES},
                                    "merge_tile_kernel": steps + 1})
    per_kernel = "; ".join(
        f"{k} {v['ms']:.5f} ms ({v['hbm_passes']} HBM passes: bound "
        f"{v['bound_ms']:.5f} ms, {100 * v['bound_ms'] / v['ms']:.1f}%; "
        f"{v['l2_passes']} from L2), {v['ulps_of_norm']:.2f} ulps of the "
        f"norm, max|err| {v['max_abs_err']:.3e}"
        for k, v in kernels.items())
    line = (f"cg fused step, HPCG-104 float64 ({n} rows, "
            f"{csr.num_nonzeros} nnz): {FUSED_STEPS} steps against the torch "
            f"step, k exact {k_exact}; to {FUSED_TOL}: {iters[0]} iterations "
            f"fused, {iters[1]} torch, solutions {sol_rel:.2e} apart (at "
            f"most {FUSED_SOLUTION_REL_MAX}); {steps} active steps replayed "
            f"under the profiler: step {fused_t['step_ms']:.4f} ms fused, "
            f"{torch_t['step_ms']:.4f} torch, K1 {fused_t['k1_ms']:.4f} / "
            f"{torch_t['k1_ms']:.4f}; vector work {fused_t['vector_ms']:.4f} "
            f"ms fused, {torch_t['vector_ms']:.4f} torch; {per_kernel}; "
            f"ok={ok}")
    return ok, line, {"kernels": kernels, "plain_ms": torch_t["vector_ms"],
                      "fused_vector_ms": fused_t["vector_ms"]}


def device_kernels(prof):
    """The device activities of a ``torch.profiler`` run: (name, start ms,
    duration ms), in start order."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            continue
        if hasattr(e, "start_ns"):
            out.append((e.name(), e.start_ns() * 1e-6, e.duration_ns() * 1e-6))
        else:
            out.append((e.name(), e.start_us() * 1e-3,
                        e.duration_us() * 1e-3))
    return sorted(out, key=lambda a: a[1])


def kernel_is(name, kernel):
    """Whether the device activity ``name`` is ``kernel``'s launch (not a
    kernel whose name ends in it: cg_pap is not pcg_pap)."""
    import re
    return re.search(rf"(?<![A-Za-z0-9_]){kernel}_kernel\b", name) is not None


def graph_ms(fn, reps=20):
    """Device ms a call of ``fn`` (kernels only, no sync), from CUDA-graph
    replays of ``reps`` calls, warm."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def multigrid_report(SV, CG, peak_gbps):
    """HPCG's preconditioned CG at the hpcg_104_mg.pcg cell's shapes:
    build_multigrid on the 104^3 stencil in float64.  At every level, on
    card tensors, each colour's step (symgs_update: the colour's product
    and update in one launch) against its plain route (the colour
    operator's K1 product, then symgs_update_plain) within COLOUR_ULPS, x
    unchanged off the colour's rows; the restriction and the prolongation
    bit-equal to their plain versions; all through the launchers the
    V-cycle binds.  Then FUSED_STEPS
    fused PCG steps (pcg_pap, pcg_update, the V-cycle, pcg_rz,
    cg_direction with z) beside pcg_torch_step from the same state, each
    value within PCG_ULPS of its norm, k exact.  Then the cell's set,
    conjugate_gradient(op, b, tol=0, maxiter=50, check_every=16,
    preconditioner="multigrid"), warm, and once more under torch.profiler
    with every launch counter reset just before: the host's counts
    (multigrid.LAUNCHES by level and kind, multigrid_cuda.LAUNCHES,
    cg_cuda's, K1's) against the V-cycles it enqueued, and the card's
    (65 V-cycles: each kernel's launches by level, placed by device
    order; no K1 right before a colour step).  Each kernel's device ms a
    launch in that set, by level, and its bytes bound from the set's own
    shapes (a colour step's: roofline_mg.symgs_bytes of its level over the
    level's 16 colour steps); the kernels alone at each level (CUDA-graph
    replays: the colour step's colour 0, and beside it that colour's K1
    product alone and its plain route), the plain versions alone, and the
    torch step's vector work (its step less the fused one's, medians of 3
    unprofiled sets each, plus the fused kernels').
    Returns (ok, line, report)."""
    from unittest import mock

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from merge_spmv_tpu_torch import build_multigrid
    from merge_spmv_tpu_torch.models import multigrid as MG
    from merge_spmv_tpu_torch.models import multigrid_cuda as MC
    from merge_spmv_tpu_torch.ops import csrmv_cuda as K
    from spmv_bench.roofline_mg import symgs_bytes
    dev, f64 = torch.device("cuda"), torch.float64
    eps = torch.finfo(f64).eps
    t0 = time.perf_counter()
    op = build_multigrid(stencil27(HPCG_WIDTH), dtype="float64")
    build_s = time.perf_counter() - t0

    def uniform(n, seed):
        return torch.from_numpy(
            np.random.RandomState(seed).uniform(-1, 1, n)).to(dev)

    def colour_ulps(got, want, colour, x, r):
        # max over the colour's rows of |got - want| in unit roundoffs of
        # (|A_c| |x| + |r|) / a_ii
        sub, rows = colour.op, colour.rows.long()
        lengths = torch.diff(sub.row_end_offsets.long(),
                             prepend=sub.row_end_offsets.new_zeros(1).long())
        of = torch.repeat_interleave(
            torch.arange(rows.numel(), device=dev), lengths)
        ax = torch.zeros(rows.numel(), dtype=f64, device=dev).index_add_(
            0, of, sub.values.abs() * x[sub.col_indices.long()].abs())
        scale = (ax + r[rows].abs()) / colour.diag.abs()
        return float(((got[rows] - want[rows]).abs() /
                      (eps / 2 * scale)).max())

    # the V-cycle's kernels at every level's shapes: the colour step
    # against its plain route, the transfers bit for bit; each alone
    exact, plain_ms, alone_ms, k1_ms = True, {}, {}, {}
    ulps_colour, off_colour = 0.0, True
    for lv, level in enumerate(op.levels):
        n = level.op.shape[0]
        x, r = uniform(n, 10 + lv), uniform(n, 20 + lv)
        for c, colour in enumerate(level.colours):
            got, want = x.clone(), x.clone()
            launch = MC.bind_colour_step(got, r, colour.op, colour.rows,
                                         colour.diag)
            launch()
            MC.symgs_update_plain(want, r, colour.op(x), colour.rows,
                                  colour.diag)
            ulps_colour = max(ulps_colour,
                              colour_ulps(got, want, colour, x, r))
            off = torch.ones(n, dtype=torch.bool, device=dev)
            off[colour.rows.long()] = False
            off_colour &= torch.equal(got[off], x[off])
            if c == 0:
                product, y = colour.op.bind(want)
                alone_ms[("symgs_update", lv)] = graph_ms(launch)
                k1_ms[lv] = graph_ms(product)

                def plain_route():
                    product()
                    MC.symgs_update_plain(want, r, y, colour.rows,
                                          colour.diag)
                plain_ms[("symgs_update", lv)] = graph_ms(plain_route)
        if level.f2c is None:
            continue
        m, axf = level.f2c.numel(), level.op(x)
        out = [torch.full((m,), 7.0, dtype=f64, device=dev)
               for _ in range(4)]
        launch = MC.bind_restrict(out[0], out[1], r, axf, level.f2c)
        launch()
        MC.restrict_plain(out[2], out[3], r, axf, level.f2c)
        exact &= torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])
        alone_ms[("mg_restrict", lv)] = graph_ms(launch)
        plain_ms[("mg_restrict", lv)] = graph_ms(
            lambda: MC.restrict_plain(out[2], out[3], r, axf, level.f2c))
        xc = uniform(m, 30 + lv)
        got, want = x.clone(), x.clone()
        launch = MC.bind_prolong(got, xc, level.f2c)
        launch()
        MC.prolong_plain(want, xc, level.f2c)
        exact &= torch.equal(got, want)
        alone_ms[("mg_prolong", lv)] = graph_ms(launch)
        plain_ms[("mg_prolong", lv)] = graph_ms(
            lambda: MC.prolong_plain(want, xc, level.f2c))
    torch.cuda.synchronize()

    # PCG's fused step beside the torch step, from the same state
    n = op.shape[0]
    b = uniform(n, 104)
    z0 = op.precondition(b, torch.empty_like(b))
    fused_state = [torch.zeros_like(b), b.clone(), z0.clone(), z0.clone(),
                   torch.sum(b * b), torch.sum(b * z0),
                   torch.zeros((), dtype=f64, device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev)]
    torch_state = [t.clone() for t in fused_state]
    fx, fr, fp, fz, frs, frz, ftol2, fk = fused_state
    step = CG.FusedCgStep(fx, fr, fp, frs, ftol2, fk, FUSED_STEPS, fz, frz)

    def err(got, want):
        d = float((got - want).abs().max())
        return d / (eps * float(torch.linalg.vector_norm(want)))

    names = ("pcg_pap", "pcg_update", "pcg_rz", "cg_direction")
    ulps = {name: 0.0 for name in names}
    k_exact = True
    for i in range(FUSED_STEPS):
        p, rz = torch_state[2], torch_state[5]
        alpha = rz / torch.sum(p * op(p))       # the torch step's alpha
        step.step(op(fp), lambda: op.precondition(fr, fz))
        SV.pcg_torch_step(op, *torch_state, FUSED_STEPS)
        got = {"pcg_pap": [(step.work[0], alpha)],
               "pcg_update": [(fused_state[j], torch_state[j])
                              for j in (0, 1, 4)],      # x, r, rs
               "pcg_rz": [(frz, torch_state[5])],
               "cg_direction": [(fp, torch_state[2])]}
        for name, pairs in got.items():
            for g, w in pairs:
                ulps[name] = max(ulps[name], err(g, w))
        k_exact &= int(fk) == int(torch_state[7]) == i + 1
        for f, t in zip(fused_state, torch_state):
            f.copy_(t)
    del step, fused_state, torch_state, fx, fr, fp, fz

    # the cell's set: host counters and the card's launches
    def solve():
        out = SV.conjugate_gradient(op, b, tol=0.0, maxiter=PCG_MAXITER,
                                    check_every=PCG_EVERY,
                                    preconditioner="multigrid")
        torch.cuda.synchronize()
        return out

    def torch_step():
        return mock.patch.object(CG, "takes", lambda device, dtype: False)

    solve()                                     # warm
    for reset in (MG.reset_launches, MC.reset_launches, CG.reset_launches,
                  K.reset_launches):
        reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x_f, info_f = solve()
    host = {"multigrid": dict(MG.LAUNCHES), "kernels": dict(MC.LAUNCHES),
            "cg": {**CG.LAUNCHES, **CG.PCG_LAUNCHES},
            "k1": K.LAUNCHES["merge_tile_fused"]}
    acts = device_kernels(prof)
    # each side's step from unprofiled sets (the profiler slows replays)
    fused_ms = [solve()[1].step_ms for _ in range(3)]
    torch_ms = []
    with torch_step():
        solve()                                 # warm: its own capture
        for _ in range(3):
            x_t, info_t = solve()
            torch_ms.append(info_t.step_ms)
    step_f, step_t = float(np.median(fused_ms)), float(np.median(torch_ms))
    sol_rel = float((x_f - x_t).abs().max() / x_t.abs().max())
    iters = (int(info_f.iterations), int(info_t.iterations))
    del x_f, x_t

    # host: hv V-cycles enqueued (the prologue's, the eager block's and
    # the recorded block's), each with every level's launches
    last = len(op.levels) - 1
    visits = {lv: 2 if lv == last else 4 for lv in range(last + 1)}
    hv = host["multigrid"].get((0, "restrict"), 0)
    want_mg = {}
    for lv in range(last + 1):
        want_mg[(lv, "colour")] = hv * 8 * visits[lv]
        if lv < last:
            for kind in ("residual", "restrict", "prolong"):
                want_mg[(lv, kind)] = hv
    colour_launches = {lv: host["multigrid"].get((lv, "colour"), 0)
                       for lv in visits}
    # K1: the residual products, PCG's A p a step and the first residual
    host_ok = (hv >= 2 and host["multigrid"] == want_mg
               and host["kernels"] == {
                   "symgs_colour": hv * 8 * sum(visits.values()),
                   "mg_restrict": hv * last, "mg_prolong": hv * last}
               and host["cg"] == {"cg_pap": 0, "cg_update": 0,
                                  "cg_direction": hv - 1, "pcg_pap": hv - 1,
                                  "pcg_update": hv - 1, "pcg_rz": hv - 1}
               and host["k1"] == hv * last + hv - 1 + 1)

    # the card: each V-cycle kernel placed on its level by device order (a
    # restriction opens the next level, a prolongation closes it)
    kinds = ("symgs_update", "mg_restrict", "mg_prolong")
    by = collections.defaultdict(list)     # (kind, level) -> ms
    pcg = {name: [] for name in names}
    depth, k1_count, k1_before_colour, prev = 0, 0, 0, ""
    for name, _, ms in acts:
        if "merge_tile_kernel" in name:
            k1_count += 1
        if kernel_is(name, "symgs_update") and "merge_tile_kernel" in prev:
            k1_before_colour += 1
        prev = name
        if kernel_is(name, "mg_prolong"):
            depth -= 1
        for kind in kinds:
            if kernel_is(name, kind):
                by[(kind, depth)].append(ms)
        if kernel_is(name, "mg_restrict"):
            depth += 1
        for kname in names:
            if kernel_is(name, kname):
                pcg[kname].append(ms)
                depth = 0
    vcycles = PCG_STEPS + 1
    card_ok = (k1_count == vcycles * last + PCG_STEPS + 1
               and k1_before_colour == 0
               and all(len(v) == PCG_STEPS for v in pcg.values())
               and all(len(by[("symgs_update", lv)]) == vcycles * 8 * v
                       for lv, v in visits.items())
               and all(len(by[(kind, lv)]) == (vcycles if lv < last else 0)
                       for kind in kinds[1:] for lv in visits))

    sizes = [lv_.op.shape[0] for lv_ in op.levels]

    def bound_ms(kind, lv):
        # a colour step's: its level's colour steps' bytes (symgs_bytes of
        # the level alone counts its 8 colours twice) over the 16; a
        # transfer's: the next level's points
        if kind == "symgs_update":
            nbytes = symgs_bytes({"levels": [op.levels[lv].dims]},
                                 "float64") / 16
        else:
            nbytes = sizes[lv + 1] * MG_ROW_BYTES[kind]
        return nbytes / peak_gbps / 1e6

    kernels, by_level = {}, {}
    for kind in kinds:
        total_ms = total_bound = 0.0
        count = 0
        levels = {}
        for lv in visits:
            times = by[(kind, lv)]
            if not times:
                continue
            bound = bound_ms(kind, lv)
            levels[lv] = {"launches": len(times),
                          "ms": float(np.mean(times)), "bound_ms": bound,
                          "alone_ms": alone_ms[(kind, lv)],
                          "plain_ms": plain_ms[(kind, lv)]}
            if kind == "symgs_update":
                levels[lv].update(colour_launches=colour_launches[lv],
                                  k1_alone_ms=k1_ms[lv])
            total_ms += sum(times)
            total_bound += bound * len(times)
            count += len(times)
        kernels[kind] = {"launches": count, "ms": total_ms / count,
                         "bound_ms": total_bound / count,
                         "plain_ms": sum(v["plain_ms"] * v["launches"]
                                         for v in levels.values()) / count,
                         "max_abs_err": 0.0 if exact else None}
        by_level[kind] = levels
    kernels["symgs_update"].update(max_abs_err=None,
                                   ulps_of_scale=ulps_colour)
    nbytes = n * 8
    for name in names:
        hbm, l2 = PCG_PASSES[name]
        kernels[name] = {"launches": len(pcg[name]),
                         "ms": float(np.mean(pcg[name])),
                         "bound_ms": hbm * nbytes / peak_gbps / 1e6,
                         "hbm_passes": hbm, "l2_passes": l2,
                         "ulps_of_norm": ulps[name]}
    fused_vector = sum(kernels[name]["ms"] for name in names)
    torch_vector = step_t - step_f + fused_vector
    ok = (exact and k_exact and host_ok and card_ok and off_colour
          and ulps_colour <= COLOUR_ULPS
          and all(u <= PCG_ULPS for u in ulps.values())
          and iters == (PCG_MAXITER, PCG_MAXITER)
          and sol_rel <= FUSED_SOLUTION_REL_MAX)
    per_kernel = "; ".join(
        f"{k} {v['launches']} launches {v['ms']:.5f} ms (bound "
        f"{v['bound_ms']:.5f} ms, {100 * v['bound_ms'] / v['ms']:.1f}%)"
        for k, v in kernels.items())
    per_level = "; ".join(
        f"{kind} L{lv} {v['launches']}x {v['ms']:.5f} ms (bound "
        f"{v['bound_ms']:.5f}, {100 * v['bound_ms'] / v['ms']:.1f}%; alone "
        f"{v['alone_ms']:.5f} ({100 * v['bound_ms'] / v['alone_ms']:.1f}%), "
        f"plain {v['plain_ms']:.5f}"
        + (f"; K1 on the colour alone {v['k1_alone_ms']:.5f}; "
           f"LAUNCHES[({lv}, 'colour')] {v['colour_launches']}"
           if kind == "symgs_update" else "") + ")"
        for kind, levels in by_level.items() for lv, v in levels.items())
    line = (f"multigrid pcg, HPCG-104 float64 (levels {sizes}, build "
            f"{build_s:.2f} s, setup_s {op.setup_s}): colour steps within "
            f"{ulps_colour:.2f} ulps of (|A_c| |x| + |r|) / a_ii of their "
            f"plain route (at most {COLOUR_ULPS}), x unchanged off the "
            f"colour {off_colour}; transfers "
            f"bit-equal their plain versions {exact}; {FUSED_STEPS} fused PCG "
            f"steps against pcg_torch_step, k exact {k_exact}, ulps of the "
            f"norm {', '.join(f'{k} {v:.2f}' for k, v in ulps.items())} (at "
            f"most {PCG_ULPS}); the cell's set: {iters[0]} iterations fused, "
            f"{iters[1]} torch, solutions {sol_rel:.2e} apart; host counters "
            f"({hv} V-cycles enqueued) {host_ok}: {host}; card launches "
            f"({vcycles} V-cycles, K1 {k1_count}, K1 right before a colour "
            f"step {k1_before_colour}) {card_ok}; step "
            f"{step_f:.4f} ms fused, {step_t:.4f} torch (medians of 3 "
            f"unprofiled sets); "
            f"vector work {fused_vector:.4f} ms fused, {torch_vector:.4f} "
            f"torch; {per_kernel}; by level: {per_level}; ok={ok}")
    del op
    torch.cuda.empty_cache()
    return ok, line, {"kernels": kernels, "by_level": by_level,
                      "plain_ms": torch_vector, "host": host}


def fastrp_k1m_report(peak_gbps):
    """K1m at the kron_g500_logn21_sym.fastrp cell's shape: the cell's graph
    (spmv_bench/generators/rmat_sym.py at its configuration's parameters:
    2^21 vertices, 182,082,942 nonzeros, FASTRP_SEED) through
    transition_operator in float32, and op.mm on X [2^21, FASTRP_K] float32
    with the launch counters reset just before the call: FASTRP_K / 64 K1m
    launches and no other kernel of the package.  The result against
    merge_csrmm_plain on the same inputs, each 64-column block at its
    launch's runs, FASTRP_PLAIN_COLS columns at a time: each entry within
    2 gamma_n of |P| |X| (float64; n the row's nonzeros), the bound on any
    two orders of summing n float32 products, and its largest difference
    in float32 ulps (2^-24) of |P| |X|, with its row's degree.  Then op.mm
    (CUDA graph) and K1m alone in turns with cuSPARSE SpMM on the same X
    (K1m, cuSPARSE, cuSPARSE, K1m; best of each), the plain version's time
    and the bytes bound (P, X and Y once).  Returns (ok, line, entry, op),
    op for fastrp_normalize_report."""
    import numpy as np
    import torch

    from merge_spmv_tpu_torch.bench import measure as M
    from merge_spmv_tpu_torch.formats.csr import CsrMatrix
    from merge_spmv_tpu_torch.ops import csrmv_cuda as K
    from merge_spmv_tpu_torch.ops.operator import transition_operator
    from merge_spmv_tpu_torch.utils.cuda_build import alignment
    from merge_spmv_tpu_torch.utils.timers import event_ms
    from spmv_bench.generators import rmat_sym

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with open(FASTRP_CONFIG) as f:
        config = json.load(f)
    g = rmat_sym.generate(config["params"], FASTRP_SEED, dev)
    csr = CsrMatrix.from_arrays(
        g["num_rows"], g["num_cols"],
        g["row_offsets"].to(torch.int32).cpu().numpy(),
        g["col_indices"].cpu().numpy(), g["values"].cpu().numpy())
    del g
    op = transition_operator(csr, dtype="float32")
    plan, n, nnz, k = op.plan, csr.num_rows, csr.num_nonzeros, FASTRP_K
    degree = torch.from_numpy(np.diff(csr.row_offsets)).to(dev)
    del csr
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(FASTRP_SEED)
    X = torch.rand(n, k, generator=gen, device=dev) * 2 - 1
    K.reset_launches()
    Y = op.mm(X)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    finite = bool(torch.isfinite(Y).all())

    # 2 gamma_n per row: n u / (1 - n u), n at most 10^5 here, u 2^-24
    u = 2.0 ** -24
    gamma = (degree.double() * u / (1 - degree.double() * u))[:, None]
    tiny = torch.finfo(torch.float64).tiny
    worst = {"err": 0.0, "ulps": 0.0, "degree": 0, "of_bound": 0.0}
    outside, plain_s, geos = 0, 0.0, []
    for c0 in range(0, k, K.MM_MAX_K):
        kw = min(K.MM_MAX_K, k - c0)
        geo = K.mm_launch_geometry(
            plan.num_tiles, plan.tile_items, op.values.dtype, dev, kw,
            alignment(op.values.element_size(), X[:, c0:c0 + kw],
                      Y[:, c0:c0 + kw]))
        geos.append(geo)
        for c in range(c0, c0 + kw, FASTRP_PLAIN_COLS):
            cols = slice(c, min(c + FASTRP_PLAIN_COLS, c0 + kw))
            xs = X[:, cols].contiguous()
            torch.cuda.synchronize()
            t = time.perf_counter()
            plain = K.merge_csrmm_plain(
                op.values, op.col_indices, op.row_end_offsets, xs,
                op.tile_rows, op.tile_nnz, plan.tile_items,
                run_tiles=geo.run_tiles)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t
            err = (Y[:, cols].double() - plain.double()).abs()
            del plain
            scale = M.abs_product(op, xs)
            outside += int((err > 2 * gamma * scale).sum())
            ulps = err / (u * scale).clamp_min(tiny)
            at = int(ulps.argmax())
            if float(ulps.view(-1)[at]) > worst["ulps"]:
                worst.update(ulps=float(ulps.view(-1)[at]),
                             degree=int(degree[at // ulps.shape[1]]))
            worst["err"] = max(worst["err"], float(err.max()))
            worst["of_bound"] = max(worst["of_bound"], float(
                (err / (2 * gamma * scale).clamp_min(tiny)).max()))
            del err, scale, ulps
    del Y

    def k1m():
        return K.merge_csrmm(op.values, op.col_indices, op.row_end_offsets,
                             X, op.tile_rows, op.tile_nnz, plan.tile_items,
                             tickets=op.tickets)
    lib = M.library_csr(op)
    times = {"k1m": [], "cusparse": []}
    for name in ("k1m", "cusparse", "cusparse", "k1m"):
        fn = k1m if name == "k1m" else (lambda: torch.sparse.mm(lib, X))
        times[name].append(event_ms(fn, iters=3, reps=2, warmup=1))
    mm_ms = M.fn_ms(lambda: op.mm(X), dev, iters=3)
    k1m_ms, lib_ms = min(times["k1m"]), min(times["cusparse"])
    bound_ms = M.spmm_bytes(n, n, nnz, k, 4) / peak_gbps / 1e6
    geo = geos[0]
    want = {"merge_tile_mm": -(-k // K.MM_MAX_K), "merge_tile_fused": 0,
            "merge_tile": 0, "carry_fixup": 0}
    ok = (nnz == config["num_nonzeros"] and n == config["num_rows"]
          and launches == want and finite and outside == 0)
    line = (f"fastrp k1m: {config['name']} {n} rows {nnz} nnz float32 "
            f"through transition_operator ({plan.describe()}), built in "
            f"{build_s:.1f} s; op.mm on X [{n}, {k}]: launches {launches} "
            f"(want {want}); against merge_csrmm_plain at each launch's runs "
            f"({[g.run_tiles for g in geos]}): max|err| "
            f"{worst['err']:.3e}, at most {worst['ulps']:.2f} float32 ulps "
            f"of |P| |X| (row of degree {worst['degree']}), "
            f"{100 * worst['of_bound']:.4f}% of 2 gamma_n, {outside} entries "
            f"past it, finite {finite}; op.mm {mm_ms:.3f} ms (CUDA graph), "
            f"K1m alone {k1m_ms:.3f} ms ({[round(t, 3) for t in times['k1m']]}"
            f"), cuSPARSE SpMM {lib_ms:.3f} ms "
            f"({[round(t, 3) for t in times['cusparse']]}), plain "
            f"{1e3 * plain_s:.0f} ms; bytes bound {bound_ms:.4f} ms at "
            f"{peak_gbps:.0f} GB/s: K1m at {100 * bound_ms / k1m_ms:.2f}%; "
            f"ok={ok}")
    lay = geo.layout
    entry = {"launches": want["merge_tile_mm"], "max_abs_err": worst["err"],
             "ulps_of_row_sums": worst["ulps"],
             "ulps_row_degree": worst["degree"], "ms": k1m_ms,
             "op_mm_ms": mm_ms, "plain_ms": 1e3 * plain_s,
             "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
             "main_path": True, "k": k,
             "launch": {"grid": geo.grid, "run_tiles": geo.run_tiles,
                        "chunk_items": geo.chunk_items,
                        "threads": geo.threads,
                        "shared_bytes": geo.shared_bytes,
                        "layout": [lay.per, lay.vector, lay.lanes],
                        "batch_rows": geo.batch_rows,
                        "carveout": geo.carveout}}
    return ok, line, entry, op


def fastrp_normalize_report(peak_gbps, op):
    """FastRP's normalise-and-accumulate (models/fastrp_cuda.py).  First on
    the main path: solvers.fastrp on the cell's operator ``op`` (from
    fastrp_k1m_report) with a projection R [rows, FASTRP_K] of +-sqrt(3)
    and 0 (FastRP's, from FASTRP_SEED) at FASTRP_WEIGHTS, with
    LAUNCHES reset and solvers.NORMALIZES read just before: one
    row_normalize launch and one "fused" step a product, no "torch" step,
    E float32 and finite.  Then at the kron_g500_logn21_sym.fastrp cell's
    shape: N [2^21, FASTRP_K] float32, normal values with every 4096th
    row 0, from FASTRP_SEED.  In each of
    FASTRP_NORMALIZE_MODES, the kernel and the torch ops (the plain
    version) on copies of the same N and E: one launch, n(N) and E within
    FASTRP_NORMALIZE_ULPS float32 ulps of their scale (n(N)'s rows have
    norm 1; E's scale is w plus its largest entry), finite, zero rows 0.
    Then both timed eagerly on one N (kernel, torch, torch, kernel; best of
    each; a call that stores n(N) divides an N already normalised, the
    same work), the kernel beside its bytes bound (the mode's passes over
    N's bytes at ``peak_gbps``).  Returns (ok, line, entry)."""
    import torch

    from merge_spmv_tpu_torch.models import fastrp_cuda as FR
    from merge_spmv_tpu_torch.models import solvers as SV
    from merge_spmv_tpu_torch.utils.timers import event_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(FASTRP_SEED)
    u = torch.rand(op.plan.num_cols, FASTRP_K, generator=gen, device=dev)
    r = torch.where(u < 1 / 6, 3 ** 0.5,
                    torch.where(u >= 5 / 6, -3 ** 0.5, 0.0))
    del u
    FR.reset_launches()
    before = dict(SV.NORMALIZES)
    emb, _ = SV.fastrp(op, r, FASTRP_WEIGHTS)
    torch.cuda.synchronize()
    main_launches = FR.LAUNCHES["row_normalize"]
    steps = {k: SV.NORMALIZES[k] - before[k] for k in before}
    products = len(FASTRP_WEIGHTS)
    main_ok = (main_launches == products
               and steps == {"fused": products, "torch": 0}
               and emb.dtype == torch.float32
               and bool(torch.isfinite(emb).all()))
    del r, emb
    torch.cuda.empty_cache()
    n0 = torch.randn(1 << 21, FASTRP_K, generator=gen, device=dev)
    n0[::4096] = 0.0
    e0 = torch.randn(n0.shape, generator=gen, device=dev) * 0.1
    zero = torch.arange(0, n0.shape[0], 4096, device=dev)
    eps = torch.finfo(torch.float32).eps
    nbytes = n0.numel() * n0.element_size()
    modes, ok = {}, main_ok
    for name, w, given, store_n, passes in FASTRP_NORMALIZE_MODES:
        got = {}
        for side, step in (("kernel", FR.row_normalize),
                           ("torch", FR.row_normalize_plain)):
            n = n0.clone()
            FR.reset_launches()
            e = step(n, e0.clone() if given else None, w, store_n=store_n)
            torch.cuda.synchronize()
            got[side] = (n, e, FR.LAUNCHES["row_normalize"])
        (nk, ek, launches), (nt, et, _) = got["kernel"], got["torch"]
        good = launches == 1 and (ek is None) == (et is None)
        n_err = e_err = n_ulps = e_ulps = 0.0
        if store_n:
            n_err = float((nk - nt).abs().max())
            n_ulps = n_err / eps
            good &= (n_ulps <= FASTRP_NORMALIZE_ULPS
                     and bool(torch.isfinite(nk).all())
                     and bool((nk[zero] == 0).all()))
        else:
            good &= torch.equal(nk, n0)
        if ek is not None:
            scale = w + (float(e0.abs().max()) if given else 0.0)
            e_err = float((ek - et).abs().max())
            e_ulps = e_err / (eps * scale)
            good &= (e_ulps <= FASTRP_NORMALIZE_ULPS
                     and bool(torch.isfinite(ek).all()))
        del got, nk, ek, nt, et
        n, e = n0.clone(), e0.clone() if given else None
        times = {"kernel": [], "torch": []}
        for side in ("kernel", "torch", "torch", "kernel"):
            step = FR.row_normalize if side == "kernel" else \
                FR.row_normalize_plain
            times[side].append(event_ms(
                lambda: step(n, e, w, store_n=store_n), iters=5, reps=3,
                warmup=1, graph=False))
        del n, e
        torch.cuda.empty_cache()
        ms = min(times["kernel"])
        bound_ms = passes * nbytes / peak_gbps / 1e6
        modes[name] = {"ms": ms, "torch_ms": min(times["torch"]),
                       "bound_ms": bound_ms,
                       "of_bound": 100 * bound_ms / ms, "passes": passes,
                       "n_ulps": n_ulps, "e_ulps": e_ulps,
                       "max_abs_err": max(n_err, e_err), "ok": good}
        ok &= good
    del n0, e0
    torch.cuda.empty_cache()
    line = (f"fastrp normalize: solvers.fastrp at weights "
            f"{list(FASTRP_WEIGHTS)} on the cell's operator: "
            f"{main_launches} row_normalize launches, steps {steps} (want "
            f"{products} fused, 0 torch), ok={main_ok}; "
            f"N [{1 << 21}, {FASTRP_K}] float32; " + "; ".join(
                f"{name}: kernel {m['ms']:.4f} ms, bound {m['bound_ms']:.4f} "
                f"ms ({m['passes']} passes at {peak_gbps:.0f} GB/s): "
                f"{m['of_bound']:.1f}%, torch ops {m['torch_ms']:.4f} ms, "
                f"n(N) {m['n_ulps']:.2f} ulps and E {m['e_ulps']:.2f} ulps "
                f"of the torch ops', ok={m['ok']}"
                for name, m in modes.items())
            + f"; a call of the cell (the three): kernel "
            f"{sum(m['ms'] for m in modes.values()):.4f} ms, torch ops "
            f"{sum(m['torch_ms'] for m in modes.values()):.4f} ms; ok={ok}")
    total = {k: sum(m[k] for m in modes.values())
             for k in ("ms", "torch_ms", "bound_ms")}
    entry = {"launches": main_launches, "max_abs_err": max(
        m["max_abs_err"] for m in modes.values()),
        "ms": total["ms"], "plain_ms": total["torch_ms"],
        "bound_ms": total["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "main_path": True, "modes": modes}
    return ok, line, entry


def pagerank_report():
    """The graph500_24.pagerank cell's path on the card.  First
    pagerank_operator's transpose on a directed graph with dangling
    vertices: the generator's graph at PAGERANK_DIRECTED_SCALE, its links
    u -> v with u < v, in float64; P's arrays equal, bit for bit, those of
    the sparse COO transpose of D^-1 A (coalesce's sort, 1 / outdeg(u)),
    each column sums to 1 within its length's rounding, or is empty for a
    dangling vertex.  Then the cell's graph (spmv_bench/generators/
    graph500.py at its configuration's parameters, PAGERANK_SEED) through
    pagerank_operator in the configuration's float64: its counts the
    configuration's, P equal to A D^-1 bit for bit (the graph is
    symmetric), its columns summing to 1; K1 on P and x uniform in
    [0, 1) against its plain version within |P| |x| and 2 gamma_n |P| |x|
    per row, timed warm and cold beside cuSPARSE and the bytes bound
    (bench/measure.py::card_spmv).  Then the cell's job,
    solvers.pagerank(op, damping, **solver_args) at the traffic's
    settings, with K1's counters reset and solvers.CAPTURES read just
    before: one fused launch a step (masked steps included), one host
    read, maxiter iterations, no graph captured; its ranks against
    models/pagerank_reference.py over the link graph in float64, the L1
    distance within the cell's rank_err limit, and the reference in
    float32 outside it (the control); PAGERANK_JOBS jobs timed on the
    host clock.  Returns (ok, line, entry)."""
    import numpy as np
    import torch

    from merge_spmv_tpu_torch.bench import measure as M
    from merge_spmv_tpu_torch.formats.csr import CsrMatrix
    from merge_spmv_tpu_torch.models import solvers as SV
    from merge_spmv_tpu_torch.models.pagerank_reference import pagerank
    from merge_spmv_tpu_torch.ops import csrmv_cuda as K
    from merge_spmv_tpu_torch.ops.operator import pagerank_operator
    from spmv_bench.generators import graph500

    dev = torch.device("cuda")
    with open(PAGERANK_CONFIG) as f:
        config = json.load(f)
    with open(PAGERANK_TRAFFIC) as f:
        traffic = json.load(f)
    with open(PAGERANK_LIMITS) as f:
        limit = json.load(f)["rank_err"]
    damping, args = float(traffic["damping"]), traffic["solver_args"]

    def host(g, offsets, cols, values):
        return CsrMatrix.from_arrays(
            g, g, offsets.to(torch.int32).cpu().numpy(),
            cols.to(torch.int32).cpu().numpy(), values.cpu().numpy())

    def column_sums_ok(op, outdeg):
        sums = torch.zeros(op.plan.num_cols, dtype=torch.float64,
                           device=dev).index_add_(
            0, op.col_indices.long(), op.values)
        full = outdeg > 0
        # a column's d terms of 1/d summed in float64: within d u of 1
        slack = outdeg[full].double() * 2.0 ** -53 * 2
        return (bool(((sums[full] - 1).abs() <= slack).all())
                and bool((sums[~full] == 0).all()))

    # the transpose on a directed graph with dangling vertices
    g = graph500.generate({**config["params"],
                           "scale": PAGERANK_DIRECTED_SCALE},
                          PAGERANK_SEED, dev)
    n_d = g["num_rows"]
    offs = g["row_offsets"]
    u = torch.repeat_interleave(torch.arange(n_d, device=dev),
                                offs[1:] - offs[:-1])
    v = g["col_indices"].long()
    del g, offs
    keep = u < v
    u, v = u[keep], v[keep]
    del keep
    outdeg_d = torch.bincount(u, minlength=n_d)
    offs_d = torch.zeros(n_d + 1, dtype=torch.int64, device=dev)
    torch.cumsum(outdeg_d, 0, out=offs_d[1:])
    op_d = pagerank_operator(
        host(n_d, offs_d, v, torch.ones(v.numel(), dtype=torch.float64)),
        dtype="float64", device=dev)
    want = torch.sparse_coo_tensor(
        torch.stack([v, u]), 1.0 / outdeg_d[u].double(),
        (n_d, n_d), check_invariants=True).coalesce()
    w_rows, w_cols = want.indices()
    w_ends = torch.cumsum(torch.bincount(w_rows, minlength=n_d), 0)
    dangling = int((outdeg_d == 0).sum())
    directed_ok = (torch.equal(op_d.row_end_offsets.long(), w_ends)
                   and torch.equal(op_d.col_indices.long(), w_cols)
                   and torch.equal(op_d.values, want.values())
                   and op_d.plan.num_nonzeros == u.numel()
                   and column_sums_ok(op_d, outdeg_d) and dangling > 0)
    nnz_d = u.numel()
    del u, v, want, w_rows, w_cols, w_ends, op_d, offs_d, outdeg_d
    torch.cuda.empty_cache()

    # the cell's graph and operator
    t0 = time.perf_counter()
    g = graph500.generate(config["params"], PAGERANK_SEED, dev)
    n, offsets, cols = g["num_rows"], g["row_offsets"], g["col_indices"]
    csr = host(n, offsets, cols, g["values"])
    del g
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = pagerank_operator(csr, dtype=config["dtype"], device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del csr
    nnz, describe, setup = op.plan.num_nonzeros, op.plan.describe(), \
        op.setup_s
    outdeg = offsets[1:] - offsets[:-1]
    # P = A D^-1 for the symmetric graph: A's pattern, 1 / deg(column)
    p_ok = (torch.equal(op.row_end_offsets.long(), offsets[1:].long())
            and torch.equal(op.col_indices, cols)
            and torch.equal(op.values,
                            1.0 / outdeg.double()[cols.long()])
            and column_sums_ok(op, outdeg))
    counts_ok = (n == config["num_rows"]
                 and nnz == config["num_nonzeros"])

    # K1 on P against its plain version, timed
    gen = torch.Generator(device=dev).manual_seed(PAGERANK_SEED)
    x = torch.rand(n, dtype=torch.float64, generator=gen, device=dev)
    k1 = M.card_spmv(op, x)
    del x
    torch.cuda.empty_cache()
    policy = k1["policy"]
    k1_ms = k1["k1_ms"][policy]

    # the cell's job, counted from 0
    K.reset_launches()
    before = dict(SV.CAPTURES)
    pr, info = SV.pagerank(op, damping, **args)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    captures = {k: SV.CAPTURES[k] - before[k] for k in before}
    reads, iterations = info.host_reads, int(info.iterations)
    steps = reads * int(args["check_every"])
    want_launches = {k: steps if k == "merge_tile_fused" else 0
                     for k in launches}
    ref = pagerank(offsets, cols, damping, int(args["maxiter"]),
                   torch.float64)
    rank_err = float((pr.double() - ref).abs().sum())
    control = pagerank(offsets, cols, damping, int(args["maxiter"]),
                       torch.float32)
    control_err = float((control.double() - ref).abs().sum())
    del pr, ref, control
    jobs = []
    for _ in range(PAGERANK_JOBS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        SV.pagerank(op, damping, **args)
        jobs.append(1e3 * (time.perf_counter() - t))
    job_ok = (launches == want_launches and reads == 1
              and iterations == int(args["maxiter"])
              and not any(captures.values()) and rank_err <= limit
              and control_err > limit)
    ok = directed_ok and p_ok and counts_ok and k1["plain_ok"] and job_ok
    del op, offsets, cols, outdeg
    torch.cuda.empty_cache()
    fp64 = k1.get("plain_err_over_fp64_bound", float("nan"))
    line = (f"pagerank cell: the transpose on a directed graph (scale "
            f"{PAGERANK_DIRECTED_SCALE}, {n_d} vertices, {nnz_d} links u < "
            f"v, {dangling} dangling) equal to the sparse COO transpose of "
            f"D^-1 A, columns summing to 1 or empty: {directed_ok}; "
            f"{config['name']} {n} vertices {nnz} nnz {config['dtype']} "
            f"generated in {gen_s:.1f} s (counts the configuration's: "
            f"{counts_ok}), pagerank_operator {build_s:.1f} s "
            f"({describe}), setup_s {setup}, P equal "
            f"to A D^-1: {p_ok}; K1 policy {policy} warm {k1_ms:.4f} ms "
            f"({k1['k1_ms']}), cold {k1['k1_cold_ms'][policy]:.4f} ms, "
            f"cuSPARSE {k1['cusparse_ms']:.4f} warm, "
            f"{k1['cusparse_cold_ms']:.4f} cold; bytes bound "
            f"{k1['bytes_bound_ms']:.4f} ms for {k1['bytes']} B "
            f"({100 * k1['bytes_bound_ms'] / k1_ms:.1f}%); plain "
            f"{k1['plain_ms']:.1f} ms, max|err| "
            f"{k1['plain_max_abs_err']:.3e}, {100 * fp64:.4f}% of 2 gamma_n "
            f"|P| |x|, ok={k1['plain_ok']}; the job "
            f"pagerank(op, {damping}, {args}): launches {launches} (want "
            f"{want_launches}), {reads} host read, {iterations} "
            f"iterations, captures {captures}, L1 from the float64 "
            f"reference {rank_err:.3e} (limit {limit}), the float32 "
            f"reference's {control_err:.3e}; jobs "
            f"{[round(t, 2) for t in jobs]} ms on the host clock; ok={ok}")
    entry = {"launches": launches["merge_tile_fused"],
             "max_abs_err": k1["plain_max_abs_err"], "ms": k1_ms,
             "plain_ms": k1["plain_ms"], "bound_ms": k1["bytes_bound_ms"],
             "bound_by": "bytes", "library_ms": k1["cusparse_ms"],
             "main_path": True, "policy": policy,
             "cold_ms": k1["k1_cold_ms"][policy],
             "job": {"launches": launches["merge_tile_fused"],
                     "host_reads": reads, "iterations": iterations,
                     "rank_err": rank_err, "control_err": control_err,
                     "ms": sorted(jobs)[len(jobs) // 2]}}
    return ok, line, entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    import numpy as np

    from merge_spmv_tpu_torch.bench.driver import run_benchmark
    from merge_spmv_tpu_torch.bench.headline import (CIRCUIT_QUARTER,
                                                     HEADLINE_KEYS)
    from merge_spmv_tpu_torch.formats import market as MK
    from merge_spmv_tpu_torch.formats import native_io as NI
    from merge_spmv_tpu_torch.bench.matrices import make_circuit_like, rmat
    from merge_spmv_tpu_torch.formats.coo import CooMatrix
    from merge_spmv_tpu_torch.formats.csr import CsrMatrix
    from merge_spmv_tpu_torch.models import cg_cuda as CG
    from merge_spmv_tpu_torch.models import fastrp_cuda as FR
    from merge_spmv_tpu_torch.models import solvers as SV
    from merge_spmv_tpu_torch.ops import csrmv_cuda as K
    from merge_spmv_tpu_torch.ops import autotune as A
    from merge_spmv_tpu_torch.ops import dia_cuda as DK
    from merge_spmv_tpu_torch.ops import split as S
    from merge_spmv_tpu_torch.ops.dia import build_dia_operator
    from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
    from merge_spmv_tpu_torch.ops.operator import (build_operator,
                                                   pagerank_operator)
    from merge_spmv_tpu_torch.ops.plan import (DEFAULT_TILE_ITEMS,
                                               L1_TILE_ITEMS,
                                               L1_WIDE_TILE_ITEMS, POLICIES,
                                               gather_sectors_per_nonzero,
                                               tile_sectors)
    from merge_spmv_tpu_torch.ops.suggest import build_suggested, suggest_backend
    from merge_spmv_tpu_torch.parallel import mp_worker as MPW
    from merge_spmv_tpu_torch.bench import measure as M
    from merge_spmv_tpu_torch.tools import bench_baseline_configs as BC
    from merge_spmv_tpu_torch.tools import bench_hotcold as BH
    from merge_spmv_tpu_torch.tools import bench_large as BL
    from merge_spmv_tpu_torch.tools import bench_multichip as MCB
    from merge_spmv_tpu_torch.tools import bench_skew as SKB
    from merge_spmv_tpu_torch.tools import bench_spmm as SPB
    from merge_spmv_tpu_torch.tools import eval_corpus as EC
    from merge_spmv_tpu_torch.tools import gather_rate as GR
    from merge_spmv_tpu_torch.tools import make_corpus as MC
    from merge_spmv_tpu_torch.tools import make_corpus_stats as MS
    from merge_spmv_tpu_torch.tools import sm_ceiling as P
    from merge_spmv_tpu_torch.tools import split_compact_bench as SCB
    from merge_spmv_tpu_torch.utils.compare import compare_results
    from merge_spmv_tpu_torch.utils.cuda_build import (build_library,
                                                       device_context,
                                                       ptxas_report,
                                                       raw_stream)
    from merge_spmv_tpu_torch.utils.device import (PEAK_FP32_GFLOPS,
                                                   device_info,
                                                   measure_stream_bandwidth)
    from merge_spmv_tpu_torch.utils.timers import chained_rate_ms, event_ms

    dev = torch.device("cuda")
    warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ 1 build
    t0 = time.perf_counter()
    sources = (K.KERNEL_SOURCE, DK.KERNEL_SOURCE, CG.KERNEL_SOURCE,
               P.KERNEL_SOURCE, GR.KERNEL_SOURCE, K.MM_SOURCE,
               FR.KERNEL_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(build_library, sources))
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs[:3] for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    info = device_info()
    tile_kernel = []
    for dt in (torch.float32, torch.float64):
        for fused in (False, True):
            for pol in POLICIES:
                blocks, regs = K.kernel_occupancy(dt, DEFAULT_TILE_ITEMS, dev,
                                                  fused, pol)
                g = K.launch_geometry(1, DEFAULT_TILE_ITEMS, dt, dev, fused,
                                      pol)
                tile_kernel.append(
                    f"{str(dt)[6:]}{' fused' if fused else ''} {pol} "
                    f"{regs} registers, {g.shared_bytes} B dynamic shared "
                    f"memory, {blocks} blocks per SM (launched: "
                    f"{g.blocks_per_sm})")
    mm_kernel = []
    for dt in (torch.float32, torch.float64):
        for k in (4, 8, 32, 64):
            blocks, regs = K.mm_kernel_occupancy(dt, DEFAULT_TILE_ITEMS, k,
                                                 dev)
            g = K.mm_launch_geometry(1, DEFAULT_TILE_ITEMS, dt, dev, k)
            mm_kernel.append(
                f"{str(dt)[6:]} k={k} layout {g.layout} {regs} registers, "
                f"two batches of {g.batch_rows} X rows in flight a walker, "
                f"{g.shared_bytes} B dynamic shared memory, carveout "
                f"{g.carveout}%, {blocks} blocks per SM (launched: "
                f"{g.blocks_per_sm})")
    # K1's instantiations (tile kernel and fix-up): any spilled bytes
    k1_spills = sorted(n for n, r in ptxas_report(logs[0]).items()
                       if r.spill_stores or r.spill_loads)
    # K1m's instantiations by -Xptxas=-v: registers and spill stores
    mm_ptxas = {n[len("merge_tile_mm_kernel<"):-1]: r
                for n, r in ptxas_report(logs[5]).items()
                if n.startswith("merge_tile_mm_kernel<")}
    mm_spills = sorted(n for n, r in mm_ptxas.items() if r.spill_stores)
    mm_named = "; ".join(
        f"<{n}>: {mm_ptxas[n].registers} registers, "
        f"{mm_ptxas[n].spill_stores} B spilled"
        for n in ("float,4,1,2", "float,4,1,8", "float,4,1,16")
        if n in mm_ptxas)
    print(f"build: {len(sources)} sources in {build_s:.2f} s; "
          f"{' | '.join(ptxas) or 'cached'}; merge_tile at "
          f"{DEFAULT_TILE_ITEMS} items: {'; '.join(tile_kernel)}; "
          f"sm_ceiling: "
          f"{sum('Compiling entry' in ln for ln in logs[3].splitlines())} "
          f"instantiations; merge_tile_mm: "
          f"{sum('Compiling entry' in ln for ln in logs[5].splitlines())} "
          f"instantiations, spills {mm_spills or 'none'}, {mm_named}; "
          f"{'; '.join(mm_kernel)}; merge_csrmv spills "
          f"{k1_spills or 'none'}")
    if k1_spills:
        print(f"build: K1 instantiations spill registers: {k1_spills}")
        return 1
    if mm_spills:
        print(f"build: K1m instantiations spill registers: {mm_spills}")
        return 1
    print(f"device: {info['device_kind']} x{info['num_devices']}; "
          f"nvidia-smi: {info['nvidia_smi']}")

    # ------------------------------------------------------------ stream
    t0 = time.perf_counter()
    stream_gbps = measure_stream_bandwidth()
    print(f"stream: triad x = x*s + y over two 256 MB float32 arrays "
          f"(12 B per element per step; CUDA-graph replay of a 64-step "
          f"chain minus a 1-step one): {stream_gbps:.1f} GB/s measured "
          f"against {info['peak_hbm_gbps']:.0f} GB/s published "
          f"({100 * stream_gbps / info['peak_hbm_gbps']:.1f}% of it); "
          f"{time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------ 2 cases
    def to_dev(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

    def run_case(csr, x, y_in, alpha, beta, tile_items, dtype):
        v, re_, ci = csr.to_device(dtype=dtype, device=dev)
        tr, tn = merge_tile_coordinates(re_, csr.num_nonzeros, tile_items)
        xk, yk = to_dev(x).to(dtype), to_dev(y_in)
        yk = None if yk is None else yk.to(dtype)
        got = K.merge_csrmv(v, ci, re_, xk, tr, tn, tile_items, yk,
                            alpha, beta)
        plain = K.merge_csrmv_plain(v, ci, re_, xk, tr, tn, tile_items, yk,
                                    alpha, beta)
        torch.cuda.synchronize()
        return got.cpu().numpy(), plain.cpu().numpy()

    cases = {
        "grid2d_small": lambda: CooMatrix.grid2d(6),
        "grid2d": lambda: CooMatrix.grid2d(20),
        "wheel_single_tile": lambda: CooMatrix.wheel(100),
        "wheel_hub_spans_tiles": lambda: CooMatrix.wheel(3000),
        "empty_rows": lambda: CooMatrix(900, 64, rows=[5, 5, 850],
                                        cols=[0, 63, 3], vals=[1., 2., 3.]),
        "leading_trailing_empty": lambda: CooMatrix(
            2100, 32, rows=[1050], cols=[7], vals=[2.0]),
        "duplicates": lambda: CooMatrix(4, 4, rows=[1, 1, 1], cols=[2, 2, 2],
                                        vals=[1., 2., 3.]),
        "powerlaw": lambda: CooMatrix.random_powerlaw(800, 700, 6000,
                                                      seed=3),
        "dense_rows": lambda: CooMatrix.dense(50, 60),
        "multi_chunk_cols": lambda: CooMatrix.random_uniform(300, 6000, 8,
                                                             seed=9),
        "tile_boundary": lambda: CooMatrix.random_uniform(256, 128, 8,
                                                          seed=1),
        "nnz0": lambda: CooMatrix(700, 9, rows=[], cols=[], vals=[]),
        "one_col": lambda: CooMatrix(6, 1, rows=[0, 2, 2, 5],
                                     cols=[0, 0, 0, 0], vals=[1., 2., 3., 4.]),
        # the fix-up's chunks (blockDim.x pairs): one row over every run,
        # G > blockDim.x; long rows meeting at a chunk's edge (pair 128 of
        # the 128-thread blocks of these tiles) and inside a warp's group
        "tail_one_row": lambda: tail_rows([600 * TILE_ITEMS_CASES]),
        "tail_chunk_edge": lambda: tail_rows(TAIL_EDGE_ROWS),
    }
    # (case, alpha, beta, with y_in, signed values)
    runs = [(name, 1.0, 0.0, False, False) for name in cases]
    runs += [("powerlaw", 2.5, -0.75, True, False),
             ("powerlaw", 1.0, 0.0, False, True)]
    failures = []
    worst = 0.0
    for i, (name, alpha, beta, with_y, signed) in enumerate(runs):
        csr = CsrMatrix.from_coo(cases[name]())
        rs = np.random.RandomState(i)
        lo = -1.0 if signed else 0.1
        csr.values = rs.uniform(lo, 1, csr.num_nonzeros).astype(np.float32)
        x = rs.uniform(lo, 1, csr.num_cols).astype(np.float32)
        y_in = (rs.uniform(lo, 1, csr.num_rows).astype(np.float32)
                if with_y else None)
        got, plain = run_case(csr, x, y_in, alpha, beta, TILE_ITEMS_CASES,
                              torch.float32)
        gold = csr.spmv_gold(x, y_in, alpha=alpha, beta=beta)
        bound = csr.spmv_abs_bound(x, y_in, alpha=alpha, beta=beta)
        for what, a, b in (("kernel/gold", got, gold),
                           ("plain/gold", plain, gold),
                           ("kernel/plain", got, plain)):
            if compare_results(a, b, verbose=False, abs_bound=bound) is not None:
                failures.append(f"{name}[{i}] {what}")
        if got.size:
            worst = max(worst, float(np.abs(got - plain).max()))
    for name in ("wheel_hub_spans_tiles", "powerlaw"):
        csr = CsrMatrix.from_coo(cases[name]())
        rs = np.random.RandomState(7)
        csr.values = rs.uniform(0.1, 1, csr.num_nonzeros)
        x = rs.uniform(0.1, 1, csr.num_cols)
        got, plain = run_case(csr, x, None, 1.0, 0.0, TILE_ITEMS_CASES,
                              torch.float64)
        gold = csr.spmv_gold(x)   # float64 gold, positive data
        for what, a in (("kernel", got), ("plain", plain)):
            if a.dtype != np.float64 or not np.allclose(a, gold, rtol=1e-12,
                                                        atol=0.0):
                failures.append(f"{name} float64 {what}")
        # bfloat16: values and x rounded to bf16, float32 arithmetic, the
        # result rounded to bf16 (relative rounding 2^-9, checked at 2^-7)
        csr16 = CsrMatrix.from_coo(cases[name]())
        csr16.values = rs.uniform(0.1, 1, csr16.num_nonzeros).astype(
            np.float32)
        op = build_operator(csr16, dtype="bfloat16",
                            tile_items=TILE_ITEMS_CASES)
        xb = torch.from_numpy(rs.uniform(0.1, 1, csr16.num_cols).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        yb = op(xb)
        rounded = csr16.astype(np.float32)
        rounded.values = op.values.cpu().numpy()
        want = rounded.spmv_gold(xb.float().cpu().numpy())
        if yb.dtype != torch.bfloat16 or not np.allclose(
                yb.float().cpu().numpy(), want, rtol=2.0**-7, atol=0.0):
            failures.append(f"{name} bfloat16")
    # the tail cases: G > the block, fused bitwise the two kernels at the
    # same runs, two calls bitwise equal
    tail_g = {}
    for name in ("tail_one_row", "tail_chunk_edge"):
        csr = CsrMatrix.from_coo(cases[name]()).astype(np.float32)
        v, re_, ci = csr.to_device(dtype=torch.float32, device=dev)
        tr, tn = merge_tile_coordinates(re_, csr.num_nonzeros,
                                        TILE_ITEMS_CASES)
        xk = torch.from_numpy(np.random.RandomState(5).uniform(
            -1, 1, csr.num_cols).astype(np.float32)).to(dev)
        args = (v, ci, re_, xk, tr, tn, TILE_ITEMS_CASES)
        geo = K.launch_geometry(tr.shape[0] - 1, TILE_ITEMS_CASES,
                                torch.float32, dev, fused=True)
        a, b = K.merge_csrmv(*args), K.merge_csrmv(*args)
        y0, crow, cval = K.merge_tile(*args, run_tiles=geo.run_tiles)
        two = K.carry_fixup(y0, crow, cval)
        torch.cuda.synchronize()
        tail_g[name] = (crow.shape[0], geo.threads)
        if not (torch.equal(a, b) and torch.equal(a, two)
                and crow.shape[0] > geo.threads):
            failures.append(f"{name} tail bits")
    print(f"cases: {len(runs)} float32 runs + float64/bfloat16 on 2 cases; "
          f"max |kernel - plain| = {worst:.3e}; the tail cases' (G pairs, "
          f"block) {tail_g}, two calls and the two kernels bitwise equal; "
          f"failures: {failures or 'none'}")
    if failures:
        return 1

    # ------------------------------------------------------------ 3 determinism
    csr = CsrMatrix.from_coo(CooMatrix.wheel(3000)).astype(np.float32)
    csr.values = np.random.RandomState(3).uniform(
        -1, 1, csr.num_nonzeros).astype(np.float32)
    op = build_operator(csr, tile_items=256)
    xw = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, csr.num_cols).astype(np.float32)).to(dev)
    y1, y2 = op(xw), op(xw)
    same = bool(torch.equal(y1, y2))
    print(f"determinism: wheel(3000), {op.plan.num_tiles} tiles, two calls "
          f"bitwise equal: {same}")
    if not same:
        return 1

    # ------------------------------------------------------------ 4 main path
    rs = np.random.RandomState(0)
    t0 = time.perf_counter()
    csr = CsrMatrix.from_coo(CooMatrix.grid3d(100)).astype(np.float32)
    csr.values = rs.uniform(0.5, 1.5, csr.num_nonzeros).astype(np.float32)
    n, nnz = csr.num_rows, csr.num_nonzeros
    x1 = np.ones(n, np.float32)
    y_in = rs.uniform(-1, 1, n).astype(np.float32)
    X = rs.uniform(0.1, 1, (n, 4)).astype(np.float32)
    host_s = time.perf_counter() - t0

    K.reset_launches()
    op = build_operator(csr, dtype="float32")
    y = op(torch.from_numpy(x1).to(dev))
    y_ab = op(torch.from_numpy(x1).to(dev), y_in=torch.from_numpy(y_in).to(dev),
              alpha=2.0, beta=1.0)
    Y = op.mm(torch.from_numpy(X).to(dev))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)

    checks = {
        "op(x)": (y, csr.spmv_gold(x1), csr.spmv_abs_bound(x1)),
        "op(x,y_in,2,1)": (y_ab, csr.spmv_gold(x1, y_in, 2.0, 1.0),
                           csr.spmv_abs_bound(x1, y_in, 2.0, 1.0)),
    }
    for k in range(X.shape[1]):
        checks[f"mm[:, {k}]"] = (Y[:, k], csr.spmv_gold(X[:, k]),
                                 csr.spmv_abs_bound(X[:, k]))
    bad = [name for name, (got, gold, bound) in checks.items()
           if got.shape != (n,) or not bool(torch.isfinite(got).all())
           or compare_results(got.cpu().numpy(), gold, verbose=False,
                              abs_bound=bound) is not None]
    xr = torch.from_numpy(np.random.RandomState(12).uniform(
        -1, 1, n).astype(np.float32)).to(dev)
    repeat_same = bool(torch.equal(op(xr), op(xr)))
    plan = op.plan
    pol = plan.policy
    geo = K.launch_geometry(plan.num_tiles, plan.tile_items, torch.float32,
                            dev, policy=pol)
    geo_f = K.launch_geometry(plan.num_tiles, plan.tile_items, torch.float32,
                              dev, fused=True, policy=pol)
    # op(x) and op(x, y_in, 2, 1): one fused launch each; op.mm's 4
    # columns: one K1m launch
    one_launch = launches == {"merge_tile": 0, "merge_tile_fused": 2,
                              "carry_fixup": 0, "merge_tile_mm": 1}
    # K1m against its plain version on the same X, at the kernel's runs
    Xd4 = torch.from_numpy(X).to(dev)
    mm_args = (op.values, op.col_indices, op.row_end_offsets, Xd4,
               op.tile_rows, op.tile_nnz, plan.tile_items)
    mm_geo = K.mm_launch_geometry(plan.num_tiles, plan.tile_items,
                                  torch.float32, dev, 4)
    Ym = K.merge_csrmm(*mm_args, tickets=op.tickets)
    Ym_plain = K.merge_csrmm_plain(*mm_args, run_tiles=mm_geo.run_tiles)
    mm_main_err = float((Ym - Ym_plain).abs().max())
    mm_main_ok = (torch.equal(Ym, Y) and all(
        compare_results(Ym[:, c].cpu().numpy(), Ym_plain[:, c].cpu().numpy(),
                        verbose=False, abs_bound=checks[f"mm[:, {c}]"][2])
        is None for c in range(X.shape[1])))
    del Ym, Ym_plain
    print(f"main: grid3d(100) {n} rows {nnz} nnz float32, {op.describe()}, "
          f"host build {host_s:.1f} s, setup_s {op.setup_s}, launches "
          f"{launches} (one fused launch per op(x), one K1m launch for "
          f"op.mm: {one_launch}), verified {len(checks) - len(bad)}/"
          f"{len(checks)}{' FAILED ' + str(bad) if bad else ''}; two op(x) "
          f"calls bitwise equal: {repeat_same}; K1m ({mm_geo.grid} blocks, "
          f"{mm_geo.blocks_per_sm} per SM, layout {mm_geo.layout}, two "
          f"batches of {mm_geo.batch_rows} X rows a walker, "
          f"{mm_geo.shared_bytes} B shared memory, carveout "
          f"{mm_geo.carveout}%) against its plain version max|err| "
          f"{mm_main_err:.3e}, within |A| |x| and equal to op.mm: "
          f"{mm_main_ok}")
    print(f"main merge_tile launch: fused G = {geo_f.grid} persistent blocks "
          f"of {geo_f.threads} threads ({geo_f.blocks_per_sm} per SM), "
          f"{geo_f.run_tiles} tiles per run over {plan.num_tiles} tiles, "
          f"{geo_f.stages} stages, {geo_f.shared_bytes} B shared memory "
          f"(opt-in above 48 KB: {geo_f.opt_in}), the last block's tail sums "
          f"{geo_f.grid} pairs; unfused G = {geo.grid} ({geo.blocks_per_sm} "
          "per SM)")
    if bad or not one_launch or not repeat_same or not mm_main_ok:
        return 1
    # merge_tile_fused launches of each path, counted from 0 around it;
    # merge_tile_mm's in mm_paths
    paths = {"main": launches["merge_tile_fused"]}
    mm_paths = {"main": launches["merge_tile_mm"]}
    router = {}

    peak_gbps = info["peak_hbm_gbps"]
    xd = torch.from_numpy(x1).to(dev)
    op_ms = chained_rate_ms(op, xd)
    op_eager_ms = chained_rate_ms(op, xd, graph=False)
    ref_bound_ms = plan.bytes_accessed() / peak_gbps / 1e6
    print(f"main timing: op(x) {op_ms:.4f} ms on the device (CUDA graph), "
          f"{op_eager_ms:.4f} ms per eager call, "
          f"{2 * nnz / op_ms / 1e6:.2f} GFLOP/s, "
          f"{plan.bytes_accessed() / op_ms / 1e6:.1f} GB/s effective "
          f"({plan.bytes_accessed()} B reference byte model), "
          f"{100 * ref_bound_ms / op_ms:.1f}% of the "
          f"{ref_bound_ms:.4f} ms bound at {peak_gbps:.0f} GB/s")

    # A/B: op(x) through the fused kernel and through merge_tile +
    # carry_fixup at the same runs, in turns (fused, two, two, fused)
    fused_op = MergeDirect(K, op, True, dev)
    two_op = MergeDirect(K, op, False, dev)
    ab_same = bool(torch.equal(fused_op(xr), two_op(xr)))
    ab = {"fused": [], "two": []}
    for name in ("fused", "two", "two", "fused"):
        o = fused_op if name == "fused" else two_op
        ab[name].append((chained_rate_ms(o, xd),
                         chained_rate_ms(o, xd, graph=False)))
    ab_dev = {k: min(v[0] for v in ab[k]) for k in ab}
    ab_eager = {k: min(v[1] for v in ab[k]) for k in ab}
    print(f"main A/B (fused, two kernels, two kernels, fused): device "
          f"{[round(v[0], 5) for v in ab['fused']]} vs "
          f"{[round(v[0], 5) for v in ab['two']]} ms, eager "
          f"{[round(v[1], 5) for v in ab['fused']]} vs "
          f"{[round(v[1], 5) for v in ab['two']]} ms; best: device fused "
          f"{ab_dev['fused']:.4f} two {ab_dev['two']:.4f} (fused - two "
          f"{ab_dev['fused'] - ab_dev['two']:+.4f}), eager fused "
          f"{ab_eager['fused']:.4f} two {ab_eager['two']:.4f}; fused bitwise "
          f"equal to the two kernels: {ab_same}")
    if not ab_same:
        return 1

    # eager op(x) by the host's clock, layer by layer
    sync = torch.cuda.synchronize
    vals, cols, rowends = op.values, op.col_indices, op.row_end_offsets
    tr, tn, T = op.tile_rows, op.tile_nnz, plan.tile_items
    lib = K._device_lib(xd.device.index)
    yb = torch.empty(n, dtype=torch.float32, device=dev)
    crb = torch.empty(geo_f.grid, dtype=torch.int32, device=dev)
    cvb = torch.empty(geo_f.grid, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def checks_only():
        K.num_merge_tiles(n, nnz, T)
        K._is_cpu(vals, cols, rowends, xd, tr, tn, None)
        K.launch_geometry(plan.num_tiles, T, torch.float32, dev, True,
                          policy=pol)
        K._check("values", vals, torch.float32)
        K._check("col_indices", cols, torch.int32, vals.shape)
        K._check("row_end_offsets", rowends, torch.int32)
        K._check("x", xd, torch.float32)
        K._check("tile_rows", tr, torch.int32)
        K._check("tile_nnz", tn, torch.int32, tr.shape)

    def alloc_only():
        torch.empty(n, dtype=torch.float32, device=dev)
        torch.empty(geo_f.grid, dtype=torch.int32, device=dev)
        torch.empty(geo_f.grid, dtype=torch.float32, device=dev)

    def context_before():
        with torch.cuda.device(dev):
            torch.cuda.current_stream(dev).cuda_stream

    def context_only():
        with device_context(dev):
            raw_stream(dev)

    def launch_only():
        lib.merge_tile_f32(vals.data_ptr(), cols.data_ptr(),
                           rowends.data_ptr(), xd.data_ptr(), None,
                           tr.data_ptr(), tn.data_ptr(), 1.0, 0.0,
                           yb.data_ptr(), crb.data_ptr(), cvb.data_ptr(), n,
                           plan.num_tiles, geo_f.run_tiles,
                           geo_f.blocks_per_sm
                           if geo_f.grid % geo_f.blocks_per_sm == 0 else 1,
                           geo_f.threads, geo_f.shared_bytes, 1,
                           POLICIES.index(plan.policy),
                           op.tickets.data_ptr(), stream)

    host = {"op(x)": host_us(lambda: op(xd), sync),
            "merge_csrmv": host_us(lambda: K.merge_csrmv(
                vals, cols, rowends, xd, tr, tn, T, tickets=op.tickets,
                policy=pol),
                sync),
            "checks": host_us(checks_only, sync),
            "allocation": host_us(alloc_only, sync),
            "context": host_us(context_only, sync),
            "context before": host_us(context_before, sync),
            "launch": host_us(launch_only, sync),
            "two": host_us(lambda: two_op(xd), sync)}
    rest_us = (host["merge_csrmv"] - host["checks"] - host["allocation"]
               - host["context"] - host["launch"])
    print("main eager host breakdown (us per call, host clock, "
          f"{HOST_CALLS} calls per sample): op(x) {host['op(x)']:.2f} = "
          f"operator layers {host['op(x)'] - host['merge_csrmv']:.2f} + "
          f"merge_csrmv wrapper {host['merge_csrmv']:.2f}, of which checks "
          f"and geometry {host['checks']:.2f}, allocation "
          f"{host['allocation']:.2f}, device context and stream "
          f"{host['context']:.2f} (before: {host['context before']:.2f}), "
          f"ctypes launch {host['launch']:.2f}, rest {rest_us:.2f}; the "
          f"two-kernel path through its wrappers {host['two']:.2f}")
    # eager op(x) through the wrappers' host path now and before, in turns
    host_ab = {"now": [], "before": []}
    for name in ("now", "before", "before", "now"):
        with wrapper_host_path((K, DK), name == "before"):
            host_ab[name].append(chained_rate_ms(op, xd, graph=False))
    print(f"main eager host path A/B (now, before, before, now): "
          f"{[round(v, 5) for v in host_ab['now']]} vs "
          f"{[round(v, 5) for v in host_ab['before']]} ms per eager op(x); "
          f"best now {min(host_ab['now']):.4f}, before "
          f"{min(host_ab['before']):.4f}; device {op_ms:.4f}; eager - device "
          f"now {min(host_ab['now']) - op_ms:+.4f}, before "
          f"{min(host_ab['before']) - op_ms:+.4f}")

    # each kernel on the main path's inputs: time, plain time, bound, library
    yk, crk, cvk = K.merge_tile(vals, cols, rowends, xd, tr, tn, T,
                                policy=pol)
    run = geo.run_tiles
    yp, crp, cvp = K.merge_tile_plain(vals, cols, rowends, xd, tr, tn, T,
                                      run_tiles=run)
    absv = vals.abs()
    ya, _, cva = K.merge_tile_plain(absv, cols, rowends, xd.abs(), tr, tn, T,
                                    run_tiles=run)
    tile_err = max(float((yk - yp).abs().max()),
                   float((cvk - cvp).abs().max()))
    tile_ok = (crk.shape == (geo.grid,) and torch.equal(crk, crp)
               and compare_results(yk.cpu().numpy(), yp.cpu().numpy(),
                                   verbose=False,
                                   abs_bound=ya.cpu().numpy()) is None
               and compare_results(cvk.cpu().numpy(), cvp.cpu().numpy(),
                                   verbose=False,
                                   abs_bound=cva.cpu().numpy()) is None)
    fk = K.carry_fixup(yk.clone(), crk, cvk, 1.0)
    fp = K.carry_fixup_plain(yk.clone(), crk, cvk, 1.0)
    fix_err = float((fk - fp).abs().max())
    fix_ok = compare_results(fk.cpu().numpy(), fp.cpu().numpy(),
                             verbose=False) is None
    run_f = geo_f.run_tiles
    yf = K.merge_csrmv(vals, cols, rowends, xd, tr, tn, T, policy=pol)
    yfp = K.merge_csrmv_plain(vals, cols, rowends, xd, tr, tn, T,
                              run_tiles=run_f)
    fused_err = float((yf - yfp).abs().max())
    fused_ok = compare_results(yf.cpu().numpy(), yfp.cpu().numpy(),
                               verbose=False,
                               abs_bound=csr.spmv_abs_bound(x1)) is None
    print(f"kernel vs plain on the main path: merge_tile_fused max|err| "
          f"{fused_err:.3e} ok={fused_ok}; merge_tile max|err| "
          f"{tile_err:.3e} ok={tile_ok}; carry_fixup max|err| {fix_err:.3e} "
          f"ok={fix_ok}")
    if not (tile_ok and fix_ok and fused_ok):
        return 1

    fused_ms = event_ms(lambda: K.merge_csrmv(vals, cols, rowends, xd, tr,
                                              tn, T, policy=pol))
    tile_ms = event_ms(lambda: K.merge_tile(vals, cols, rowends, xd, tr, tn,
                                            T, policy=pol))
    # the plain versions synchronise (data-dependent sizes): timed eagerly
    tile_plain_ms = event_ms(lambda: K.merge_tile_plain(
        vals, cols, rowends, xd, tr, tn, T, run_tiles=run), iters=5,
        graph=False)
    fused_plain_ms = event_ms(lambda: K.merge_csrmv_plain(
        vals, cols, rowends, xd, tr, tn, T, run_tiles=run_f), iters=5,
        graph=False)
    # int32 offsets and columns, the index width the tile kernel streams
    csr_t = torch.sparse_csr_tensor(
        torch.from_numpy(csr.row_offsets.astype(np.int32)).to(dev),
        cols, vals, size=(n, csr.num_cols))
    assert csr_t.crow_indices().dtype == torch.int32
    assert csr_t.col_indices().dtype == torch.int32
    cusparse_ms = event_ms(lambda: torch.mv(csr_t, xd))
    ycopy = yk.clone()
    fix_ms = event_ms(lambda: K.carry_fixup(ycopy, crk, cvk, 1.0))
    fix_plain_ms = event_ms(lambda: K.carry_fixup_plain(ycopy, crk, cvk, 1.0),
                            graph=False)
    ypad = torch.zeros(n + 1, dtype=ycopy.dtype, device=dev)
    index_add_ms = event_ms(lambda: ypad.index_add_(0, crk.long(), cvk,
                                                    alpha=1.0))
    # back-to-back launches find part of the streams in the 50 MB L2; a
    # 256 MB write before each launch evicts it (cold = both - the write)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    flush_ms = event_ms(lambda: flush.fill_(1.0), iters=20)
    fused_cold_ms = event_ms(lambda: (flush.fill_(1.0), K.merge_csrmv(
        vals, cols, rowends, xd, tr, tn, T, policy=pol)),
        iters=20) - flush_ms
    two_cold_ms = event_ms(lambda: (flush.fill_(1.0), K.carry_fixup(
        *K.merge_tile(vals, cols, rowends, xd, tr, tn, T, run_tiles=run_f,
                      policy=pol))),
        iters=20) - flush_ms
    tile_cold_ms = event_ms(lambda: (flush.fill_(1.0), K.merge_tile(
        vals, cols, rowends, xd, tr, tn, T, policy=pol)),
        iters=20) - flush_ms
    cusparse_cold_ms = event_ms(lambda: (flush.fill_(1.0), torch.mv(
        csr_t, xd)), iters=20) - flush_ms
    vals64, xd64 = vals.double(), xd.double()
    geo64 = K.launch_geometry(plan.num_tiles, T, torch.float64, dev,
                              fused=True, policy=pol)
    y64 = K.merge_csrmv(vals64, cols, rowends, xd64, tr, tn, T, policy=pol)
    ok64 = np.allclose(y64.cpu().numpy(),
                       csr.astype(np.float64).spmv_gold(np.ones(n)),
                       rtol=1e-12, atol=0.0) and torch.equal(
        y64, K.carry_fixup(*K.merge_tile(vals64, cols, rowends, xd64, tr, tn,
                                         T, run_tiles=geo64.run_tiles,
                                         policy=pol)))
    fused64_ms = event_ms(lambda: K.merge_csrmv(vals64, cols, rowends, xd64,
                                                tr, tn, T, policy=pol))
    del vals64, xd64, y64

    # bound: each input read once, each output written once, at the
    # published HBM rate; operations at the published fp32 rate.  The
    # fused kernel's carry pairs are scratch, not an output.
    vs = 4
    pairs = geo.grid
    coord_bytes = 2 * (plan.num_tiles + 1) * 4
    fused_bytes = (nnz * (vs + 4) + n * 4 + csr.num_cols * vs + coord_bytes
                   + n * vs)
    fused_bound = max(fused_bytes / peak_gbps / 1e6,
                      2 * nnz / PEAK_FP32_GFLOPS / 1e6)
    tile_bytes = fused_bytes + pairs * (4 + vs)
    tile_bound = max(tile_bytes / peak_gbps / 1e6,
                     2 * nnz / PEAK_FP32_GFLOPS / 1e6)
    fused64_bytes = (nnz * (8 + 4) + n * 4 + csr.num_cols * 8 + coord_bytes
                     + n * 8)
    fix_rows = int(torch.unique(crk[crk < n]).numel())
    fix_bytes = pairs * (4 + vs) + 2 * fix_rows * vs
    fix_bound = max(fix_bytes / peak_gbps / 1e6,
                    (pairs + fix_rows) / PEAK_FP32_GFLOPS / 1e6)
    print(f"kernel timing: merge_tile_fused {fused_ms:.4f} ms warm, "
          f"{fused_cold_ms:.4f} ms cold L2 ({flush_ms:.4f} ms write "
          f"subtracted), plain {fused_plain_ms:.4f}, bound "
          f"{fused_bound:.4f} for {fused_bytes} B "
          f"({100 * fused_bound / fused_ms:.1f}% of it warm, "
          f"{100 * fused_bound / fused_cold_ms:.1f}% cold); merge_tile + "
          f"carry_fixup at the same runs cold {two_cold_ms:.4f} (fused - "
          f"two {fused_cold_ms - two_cold_ms:+.4f}); merge_tile "
          f"{tile_ms:.4f} warm, {tile_cold_ms:.4f} cold, plain "
          f"{tile_plain_ms:.4f}, bound {tile_bound:.4f}; cuSPARSE "
          f"{cusparse_ms:.4f} warm, {cusparse_cold_ms:.4f} cold; fused / "
          f"cuSPARSE {fused_ms / cusparse_ms:.3f} warm, "
          f"{fused_cold_ms / cusparse_cold_ms:.3f} cold; float64 fused "
          f"{fused64_ms:.4f} ms (G = {geo64.grid}, bound "
          f"{fused64_bytes / peak_gbps / 1e6:.4f}, verified and equal to "
          f"the two kernels {ok64}); carry_fixup {fix_ms:.4f} ms on {pairs} "
          f"pairs (plain {fix_plain_ms:.4f}, index_add_ {index_add_ms:.4f}, "
          f"bound {fix_bound:.6f} for {fix_bytes} B)")
    if not ok64:
        return 1

    # bfloat16 at full size: values and x rounded to bfloat16, float32
    # arithmetic, the result rounded once (2^-9; checked at 2^-7, all
    # terms positive), timed beside float32 op(x)
    r16 = np.random.RandomState(16)
    K.reset_launches()
    op16 = build_operator(csr, dtype="bfloat16")
    x16 = torch.from_numpy(r16.uniform(0.5, 1.5, n).astype(
        np.float32)).to(dev).bfloat16()
    y16 = op16(x16)
    torch.cuda.synchronize()
    paths["bf16"] = K.LAUNCHES["merge_tile_fused"]
    rounded = csr.astype(np.float32)
    rounded.values = op16.values.cpu().numpy()
    ok16 = (y16.dtype == torch.bfloat16 and tuple(y16.shape) == (n,)
            and np.allclose(y16.float().cpu().numpy(),
                            rounded.spmv_gold(x16.float().cpu().numpy()),
                            rtol=2.0 ** -7, atol=0.0))
    bf16_ms = chained_rate_ms(op16, x16)
    print(f"main bfloat16: grid3d(100) through build_operator(dtype="
          f"'bfloat16'), {op16.plan.describe()}: {paths['bf16']} fused "
          f"launch, verified {ok16}; op(x) {bf16_ms:.4f} ms on the device "
          f"against float32 {op_ms:.4f} ({bf16_ms / op_ms:.3f}x; the "
          f"conversions of x and y to and from float32 included)")
    if not ok16 or paths["bf16"] != 1:
        return 1
    del op16, x16, y16, rounded

    # ------------------------------------------------------------ fp64 row
    # one 4,000,000-nonzero row in float64 through K1, the card's twin of
    # tests/test_fp64_audit.py:70: positive terms, so any summation order
    # is within gamma_n = n u / (1 - n u) of the exact sum (u = 2^-53);
    # held to 2 gamma_n (with the NumPy dot's own error) and to 64 * 2^-24
    nl = LONG_ROW_NNZ
    row = CsrMatrix(1, nl, np.array([0, nl], np.int32),
                    np.arange(nl, dtype=np.int32),
                    np.random.RandomState(0).uniform(0.0, 1.0, nl))
    xl = np.random.RandomState(1).uniform(0.5, 1.5, nl)
    gold_l = float(np.dot(row.values, xl))
    K.reset_launches()
    op_l = build_operator(row, dtype="float64")
    y_l = op_l(torch.from_numpy(xl).to(dev))
    torch.cuda.synchronize()
    paths["fp64_long_row"] = K.LAUNCHES["merge_tile_fused"]
    rel_l = abs(float(y_l[0]) - gold_l) / abs(gold_l)
    gamma_l = nl * 2.0 ** -53 / (1 - nl * 2.0 ** -53)
    ok_l = (y_l.dtype == torch.float64 and rel_l <= 2 * gamma_l
            and rel_l < 64 * 2.0 ** -24 and paths["fp64_long_row"] == 1)
    print(f"fp64 long row: 1 x {nl} float64 through K1 "
          f"({op_l.plan.describe()}), {paths['fp64_long_row']} launch: "
          f"relative error {rel_l:.3e} against the float64 NumPy dot "
          f"(2 gamma_n {2 * gamma_l:.3e}, 64 * 2^-24 "
          f"{64 * 2.0 ** -24:.3e}): within both {ok_l}")
    if not ok_l:
        return 1
    del row, xl, op_l, y_l

    # ------------------------------------------------------------ 5 dia cases
    def dia_coo(name, gen):
        if name == "grid3d12":
            return CooMatrix.grid3d(12)
        if name == "grid3d17":
            return CooMatrix.grid3d(17)
        if name == "grid2d37":
            return CooMatrix.grid2d(37)
        if name == "rectangular":
            m_, n_ = 300, 400
            return CooMatrix(m_, n_, np.r_[np.arange(m_), np.arange(m_)],
                             np.r_[np.arange(m_), np.arange(m_) + 50],
                             np.ones(2 * m_))
        if name == "duplicates":
            return CooMatrix(3, 3, [0, 0, 1, 2, 2, 2], [0, 0, 1, 2, 2, 0],
                             [1., 2., 3., 4., 5., 6.])
        base = CooMatrix.grid2d(40)   # "mixed": stencil + scattered extras
        return CooMatrix(1600, 1600,
                         np.r_[base.rows, gen.randint(0, 1600, 300)],
                         np.r_[base.cols, gen.randint(0, 1600, 300)],
                         np.r_[base.vals, gen.uniform(-1, 1, 300)])

    dia_runs = [(name, 1.0, 0.0) for name in
                ("grid3d12", "grid3d17", "grid2d37", "rectangular",
                 "duplicates", "mixed")]
    dia_runs += [("grid3d12", 1.5, -0.5), ("mixed", 2.0, 1.0)]
    failures, dia_case_err = [], 0.0
    for i, (name, alpha, beta) in enumerate(dia_runs):
        rd = np.random.RandomState(20 + i)
        csr_d = CsrMatrix.from_coo(dia_coo(name, rd)).astype(np.float32)
        csr_d.values = rd.uniform(-1, 1, csr_d.num_nonzeros).astype(
            np.float32)
        op_d = build_dia_operator(csr_d,
                                  min_coverage=0.3 if name == "duplicates"
                                  else 0.5)
        x = rd.uniform(-1, 1, csr_d.num_cols).astype(np.float32)
        y0 = rd.uniform(-1, 1, csr_d.num_rows).astype(np.float32)
        xc = torch.from_numpy(x).to(dev)
        kern = DK.dia_matvec(op_d.vtab, xc, op_d.offsets_t, op_d.num_rows,
                             op_d.num_cols, alpha)
        plain = DK.dia_matvec_plain(op_d.vtab, xc, op_d.offsets_t,
                                    op_d.num_rows, op_d.num_cols, alpha)
        got = op_d(xc, y_in=torch.from_numpy(y0).to(dev), alpha=alpha,
                   beta=beta)
        torch.cuda.synchronize()
        dia_case_err = max(dia_case_err,
                           float((kern - plain).abs().max()))
        absd = csr_d.astype(np.float64)
        absd.values = np.abs(absd.values)
        table_bound = abs(alpha) * absd.spmv_gold(np.abs(x))
        if compare_results(kern.cpu().numpy(), plain.cpu().numpy(),
                           verbose=False, abs_bound=table_bound) is not None:
            failures.append(f"{name}[{i}] kernel/plain")
        if compare_results(got.cpu().numpy(),
                           csr_d.spmv_gold(x, y0, alpha, beta),
                           verbose=False,
                           abs_bound=csr_d.spmv_abs_bound(
                               x, y0, alpha, beta)) is not None:
            failures.append(f"{name}[{i}] op/gold")
    for name in ("grid2d37", "mixed"):
        rd = np.random.RandomState(7)
        csr_d = CsrMatrix.from_coo(dia_coo(name, rd))
        csr_d.values = rd.uniform(0.1, 1, csr_d.num_nonzeros)
        x = rd.uniform(0.1, 1, csr_d.num_cols)
        op_d = build_dia_operator(csr_d, dtype="float64")
        y = op_d(torch.from_numpy(x).to(dev))
        if y.dtype != torch.float64 or not np.allclose(
                y.cpu().numpy(), csr_d.spmv_gold(x), rtol=1e-12, atol=0.0):
            failures.append(f"{name} float64")
        # bfloat16: table and x rounded to bf16, float32 arithmetic, the
        # result rounded once (2^-9, checked at 2^-8 of |A|.|x|)
        csr16 = csr_d.astype(np.float32)
        op_d = build_dia_operator(csr16, dtype="bfloat16")
        xb = torch.from_numpy(x.astype(np.float32)).to(dev).bfloat16()
        yb = op_d(xb)
        r16 = csr16.astype(np.float32)
        r16.values = torch.from_numpy(r16.values).bfloat16().float().numpy()
        xr = xb.float().cpu().numpy()
        err = np.abs(yb.float().cpu().numpy() - r16.spmv_gold(xr))
        if yb.dtype != torch.bfloat16 or not (
                err <= 2.0 ** -8 * r16.spmv_abs_bound(
                    xr, segmented_block=0)).all():
            failures.append(f"{name} bfloat16")
    op_d = build_dia_operator(CsrMatrix.from_coo(CooMatrix.grid3d(17)))
    xw = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, op_d.num_cols).astype(np.float32)).to(dev)
    if not torch.equal(op_d(xw), op_d(xw)):
        failures.append("repeat calls differ")
    print(f"dia cases: {len(dia_runs)} float32 runs + float64/bfloat16 on 2 "
          f"cases + a repeat; max |kernel - plain| = {dia_case_err:.3e}; "
          f"failures: {failures or 'none'}")
    if failures:
        return 1

    # ------------------------------------------------------------ 6 dia main
    DK.reset_launches()
    K.reset_launches()
    op_dia = build_dia_operator(csr, dtype="float32")
    yd = op_dia(torch.from_numpy(x1).to(dev))
    yd_ab = op_dia(torch.from_numpy(x1).to(dev),
                   y_in=torch.from_numpy(y_in).to(dev), alpha=2.0, beta=1.0)
    Yd = op_dia.mm(torch.from_numpy(X[:, :4]).to(dev))
    torch.cuda.synchronize()
    dia_launches = dict(DK.LAUNCHES)
    pure_merge = dict(K.LAUNCHES)
    dia_mm_paths = {"main": dia_launches["dia_matmat"]}
    # K3m against its plain version on the same X
    Xd4 = torch.from_numpy(X[:, :4]).to(dev)
    k3m_args = (op_dia.vtab, Xd4, op_dia.offsets_t, op_dia.num_rows,
                op_dia.num_cols)
    Yk3, Yk3_plain = DK.dia_matmat(*k3m_args), DK.dia_matmat_plain(*k3m_args)
    k3m_main_err = float((Yk3 - Yk3_plain).abs().max())
    k3m_main_ok = all(
        compare_results(Yk3[:, c].cpu().numpy(), Yk3_plain[:, c].cpu().numpy(),
                        verbose=False, abs_bound=csr.spmv_abs_bound(X[:, c]))
        is None for c in range(4))
    del Yk3, Yk3_plain
    checks = {"op(x)": (yd, checks["op(x)"][1], checks["op(x)"][2]),
              "op(x,y_in,2,1)": (yd_ab, checks["op(x,y_in,2,1)"][1],
                                 checks["op(x,y_in,2,1)"][2])}
    for k in range(4):
        checks[f"mm[:, {k}]"] = (Yd[:, k], csr.spmv_gold(X[:, k]),
                                 csr.spmv_abs_bound(X[:, k]))
    bad = [name for name, (got, gold, bound) in checks.items()
           if got.shape != (n,) or not bool(torch.isfinite(got).all())
           or compare_results(got.cpu().numpy(), gold, verbose=False,
                              abs_bound=bound) is not None]
    print(f"dia main: grid3d(100) {n} rows {nnz} nnz float32, "
          f"{op_dia.describe()}, launches {dia_launches} (merge "
          f"{pure_merge}), verified {len(checks) - len(bad)}/{len(checks)}"
          f"{' FAILED ' + str(bad) if bad else ''}; K3m against its plain "
          f"version max|err| {k3m_main_err:.3e} (within |A| |x|: "
          f"{k3m_main_ok})")
    if (bad or dia_launches != {"dia_matvec": 2, "dia_matmat": 1}
            or any(pure_merge.values()) or op_dia.rest_op is not None
            or op_dia.offsets.size != 6 or not k3m_main_ok):
        return 1

    # the same matrix with 1% scattered extras: the leftover runs K1
    extra = nnz // 100
    rx = np.random.RandomState(1)
    rows_all = np.r_[csr.row_ids(), rx.randint(0, n, extra)]
    cols_all = np.r_[csr.col_indices, rx.randint(0, n, extra)]
    vals_all = np.r_[csr.values, rx.uniform(0.5, 1.5, extra).astype(
        np.float32)]
    csr_mix = CsrMatrix.from_coo(CooMatrix(n, n, rows_all, cols_all,
                                           vals_all)).astype(np.float32)
    DK.reset_launches()
    K.reset_launches()
    op_mix = build_dia_operator(csr_mix, dtype="float32")
    ym = op_mix(torch.from_numpy(x1).to(dev))
    torch.cuda.synchronize()
    mix_launches = {**DK.LAUNCHES, **K.LAUNCHES}
    mix_ok = compare_results(ym.cpu().numpy(), csr_mix.spmv_gold(x1),
                             verbose=False,
                             abs_bound=csr_mix.spmv_abs_bound(x1)) is None
    print(f"dia main, 1% extras: {csr_mix.num_nonzeros} nnz, "
          f"{op_mix.describe()}, launches {mix_launches}, verified {mix_ok}")
    # the leftover: one fused launch, no separate fix-up
    if not mix_ok or mix_launches != {"dia_matvec": 1, "dia_matmat": 0,
                                      "merge_tile": 0,
                                      "merge_tile_fused": 1,
                                      "carry_fixup": 0, "merge_tile_mm": 0}:
        return 1
    dia_launches["dia_matvec"] += mix_launches["dia_matvec"]
    paths["dia_leftover"] = mix_launches["merge_tile_fused"]

    dia_op_ms = chained_rate_ms(op_dia, xd)
    dia_op_eager_ms = chained_rate_ms(op_dia, xd, graph=False)
    dia_host_ab = {"now": [], "before": []}
    for name in ("now", "before", "before", "now"):
        with wrapper_host_path((K, DK), name == "before"):
            dia_host_ab[name].append(chained_rate_ms(op_dia, xd,
                                                     graph=False))
    print(f"dia eager host path A/B (now, before, before, now): "
          f"{[round(v, 5) for v in dia_host_ab['now']]} vs "
          f"{[round(v, 5) for v in dia_host_ab['before']]} ms per eager "
          f"op(x); best now {min(dia_host_ab['now']):.4f}, before "
          f"{min(dia_host_ab['before']):.4f}; device {dia_op_ms:.4f}")
    mix_op_ms = chained_rate_ms(op_mix, xd)
    mix_fused = DiaDirect(K, DK, op_mix, True, dev)
    mix_two = DiaDirect(K, DK, op_mix, False, dev)
    xm = torch.from_numpy(np.random.RandomState(13).uniform(
        -1, 1, n).astype(np.float32)).to(dev)
    mix_same = bool(torch.equal(mix_fused(xm), mix_two(xm)))
    mix_ab = [chained_rate_ms(o, xd) for o in (mix_fused, mix_two, mix_two,
                                                mix_fused)]
    print(f"dia main, 1% extras A/B (fused, two kernels, two kernels, "
          f"fused): device {[round(t, 5) for t in mix_ab]} ms, fused - two "
          f"{min(mix_ab[0], mix_ab[3]) - min(mix_ab[1], mix_ab[2]):+.4f}; "
          f"fused bitwise equal to the two kernels: {mix_same}")
    if not mix_same:
        return 1
    vt, offs_t = op_dia.vtab, op_dia.offsets_t
    D = vt.shape[0]
    kd = DK.dia_matvec(vt, xd, offs_t, n, n)
    pd = DK.dia_matvec_plain(vt, xd, offs_t, n, n)
    ad = DK.dia_matvec_plain(vt.abs(), xd.abs(), offs_t, n, n)
    dia_err = float((kd - pd).abs().max())
    dia_ok = compare_results(kd.cpu().numpy(), pd.cpu().numpy(),
                             verbose=False,
                             abs_bound=ad.cpu().numpy()) is None
    dia_ms = event_ms(lambda: DK.dia_matvec(vt, xd, offs_t, n, n))
    dia_plain_ms = event_ms(lambda: DK.dia_matvec_plain(vt, xd, offs_t, n, n),
                            iters=5, graph=False)
    dia_cusparse_ms = event_ms(lambda: torch.mv(csr_t, xd))
    # the DIA kernel's 32 MB fits the 50 MB L2: cold = after a 256 MB write
    dia_cold_ms = event_ms(lambda: (flush.fill_(1.0), DK.dia_matvec(
        vt, xd, offs_t, n, n)), iters=20) - flush_ms
    dia_bytes = op_dia.plan.table_bytes_accessed()
    dia_bound = max(dia_bytes / peak_gbps / 1e6,
                    2 * D * n / PEAK_FP32_GFLOPS / 1e6)
    print(f"dia timing: op(x) {dia_op_ms:.4f} ms on the device (CUDA graph), "
          f"{dia_op_eager_ms:.4f} ms per eager call; 1% extras op(x) "
          f"{mix_op_ms:.4f} ms; dia_matvec {dia_ms:.4f} ms (plain "
          f"{dia_plain_ms:.4f}, cuSPARSE CsrMV on the same matrix "
          f"{dia_cusparse_ms:.4f}, bound {dia_bound:.4f} for {dia_bytes} B, "
          f"{100 * dia_bound / dia_ms:.1f}% of it); merge op(x) {op_ms:.4f}; "
          f"kernel vs plain max|err| {dia_err:.3e} ok={dia_ok}")
    print(f"cold L2 (256 MB written before each launch, {flush_ms:.4f} ms "
          f"subtracted): dia_matvec {dia_cold_ms:.4f} ms "
          f"({100 * dia_bound / dia_cold_ms:.1f}% of its bound); "
          f"merge_tile_fused {fused_cold_ms:.4f} ms, merge_tile "
          f"{tile_cold_ms:.4f} ms and cuSPARSE {cusparse_cold_ms:.4f} ms "
          "(main phase)")
    if not dia_ok:
        return 1
    del op_dia, op_mix, csr_mix, rows_all, cols_all, vals_all, mix_fused
    del mix_two, fused_op, two_op

    # ------------------------------------------------------------ 7 skew pair
    del csr, op, csr_t, X, Y
    nk, deg = 1 << 19, 8
    nnz_k = nk * deg
    centers = (np.arange(nnz_k, dtype=np.int64) * nk) // nnz_k
    cols_k = np.clip(centers + rs.randint(-2048, 2048, nnz_k), 0, nk - 1)
    ones = np.ones(nnz_k, np.float32)
    rows_u = np.repeat(np.arange(nk, dtype=np.int64), deg)
    raw = rs.pareto(1.6, nk) + 1.0
    degs = np.maximum(1, (raw * (nnz_k / raw.sum())).astype(np.int64))
    diff = int(nnz_k - degs.sum())
    if diff > 0:
        degs[np.argsort(-degs)[:diff]] += 1
    elif diff < 0:
        shrinkable = np.flatnonzero(degs > 1)
        degs[shrinkable[np.argsort(-degs[shrinkable])[:-diff]]] -= 1
    rows_p = np.repeat(np.arange(nk, dtype=np.int64), degs)
    skew = {}
    for name, rows in (("uniform", rows_u), ("powerlaw", rows_p)):
        c = CsrMatrix.from_coo(CooMatrix(nk, nk, rows, cols_k, ones)
                               ).astype(np.float32)
        o = build_operator(c)
        xo = torch.ones(nk, dtype=torch.float32, device=dev)
        ok = compare_results(o(xo).cpu().numpy(), c.spmv_gold(np.ones(nk)),
                             verbose=False,
                             abs_bound=c.spmv_abs_bound(np.ones(nk))) is None
        two = MergeDirect(K, o, False, dev)
        ok = ok and bool(torch.equal(MergeDirect(K, o, True, dev)(xo),
                                     two(xo)))
        skew[name] = (chained_rate_ms(o, xo), ok,
                      int(np.diff(c.row_offsets).max()),
                      chained_rate_ms(two, xo))
        del c, o, two
    (ms_u, ok_u, max_u, two_u) = skew["uniform"]
    (ms_p, ok_p, max_p, two_p) = skew["powerlaw"]
    print(f"skew: {nk} rows {nnz_k} nnz, uniform {ms_u:.4f} ms (max row "
          f"{max_u}, verified and fused bitwise equal to the two kernels "
          f"{ok_u}), powerlaw {ms_p:.4f} ms (max row {max_p}, verified "
          f"{ok_p}), per-nnz ratio uniform/powerlaw {ms_u / ms_p:.3f} (at "
          f"least {SKEW_RATIO_MIN}); two kernels: uniform {two_u:.4f}, "
          f"powerlaw {two_p:.4f}, ratio {two_u / two_p:.3f}")
    if not (ok_u and ok_p) or ms_u / ms_p < SKEW_RATIO_MIN:
        return 1
    del skew, rows_u, rows_p, cols_k, ones

    # the wheel of the stats corpus (wheel_1m: its hub row's carries come
    # from a third of the runs, all summed by the fused kernel's tail):
    # K1 beside cuSPARSE, and the tail's share, the fused kernel against
    # the tile kernel alone and the two kernels at the same runs
    rw = np.random.RandomState(14)
    cw = CsrMatrix.from_coo(CooMatrix.wheel(1 << 20)).astype(np.float32)
    cw.values = rw.uniform(0.5, 1.5, cw.num_nonzeros).astype(np.float32)
    xh = rw.uniform(-1, 1, cw.num_cols).astype(np.float32)
    xw = torch.from_numpy(xh).to(dev)
    K.reset_launches()
    ow = build_operator(cw)
    yw = ow(xw)
    torch.cuda.synchronize()
    wheel_launches = K.LAUNCHES["merge_tile_fused"]
    fused_w, two_w = MergeDirect(K, ow, True, dev), MergeDirect(K, ow, False,
                                                                 dev)
    wheel_ok = (verified(yw, cw, xh) and bool(torch.equal(yw, ow(xw)))
                and bool(torch.equal(fused_w(xw), two_w(xw))))
    wargs = (ow.values, ow.col_indices, ow.row_end_offsets, xw,
             ow.tile_rows, ow.tile_nnz, ow.plan.tile_items)
    yp = K.merge_csrmv_plain(*wargs, run_tiles=fused_w.run)
    w_err = float((yw - yp).abs().max())
    wheel_ok = wheel_ok and compare_results(
        yw.cpu().numpy(), yp.cpu().numpy(), verbose=False,
        abs_bound=cw.spmv_abs_bound(xh)) is None
    w_plain = event_ms(lambda: K.merge_csrmv_plain(
        *wargs, run_tiles=fused_w.run), iters=3, reps=2, graph=False)
    w_ms = event_ms(lambda: fused_w(xw), iters=20)
    w_two = event_ms(lambda: two_w(xw), iters=20)
    w_tile = event_ms(lambda: K.merge_tile(
        *wargs, run_tiles=fused_w.run, policy=fused_w.policy), iters=20)
    lib_w = M.library_csr(ow)
    w_lib = event_ms(lambda: torch.mv(lib_w, xw), iters=20)
    w_bytes = csr_bytes(cw.num_rows, cw.num_cols, cw.num_nonzeros)
    w_bound = w_bytes / info["peak_hbm_gbps"] / 1e6
    G_w = -(-ow.plan.num_tiles // fused_w.run)
    print(f"skew wheel: wheel_1m {cw.num_rows} rows {cw.num_nonzeros} nnz, "
          f"{ow.describe()}, G = {G_w} pairs; K1 (fused) {w_ms:.4f} ms "
          f"beside cuSPARSE {w_lib:.4f} ms ({w_ms / w_lib:.3f}x); the tile "
          f"kernel alone {w_tile:.4f}, the two kernels {w_two:.4f}: the "
          f"tail's share of the fused time {(w_ms - w_tile) / w_ms:.3f}; "
          f"bytes bound {w_bound:.4f}; plain {w_plain:.2f} ms, max|err| "
          f"{w_err:.3e}; one launch {wheel_launches == 1}; verified, two "
          f"calls and the two kernels bitwise equal: {wheel_ok}")
    if not wheel_ok or wheel_launches != 1:
        return 1
    k1_w = {"name": "merge_tile_fused@wheel_1m", "route": "cuda",
            "source": "merge_spmv_tpu_torch/csrc/merge_csrmv.cu",
            "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:150",
            "launches": wheel_launches, "max_abs_err": w_err, "ms": w_ms,
            "plain_ms": w_plain, "bound_ms": w_bound, "bound_by": "bytes",
            "library_ms": w_lib, "main_path": True,
            "policy": ow.plan.policy, "two_kernels_ms": w_two,
            "tile_alone_ms": w_tile}
    del cw, ow, yw, yp, lib_w, fused_w, two_w, wargs, xw

    # the gather policy's pick for a row-local band at full size
    # (banded_n1024k_bw128_d5 of the stats corpus), both policies timed
    cb_ = CsrMatrix.from_coo(MS.build_gens()["banded_n1024k_bw128_d5"]()
                             ).astype(np.float32)
    ob = build_operator(cb_)
    xb = torch.ones(cb_.num_cols, device=dev)
    band_ok = verified(ob(xb), cb_, np.ones(cb_.num_cols, np.float32))
    band_ms = {}
    for pol, T in (("stream", DEFAULT_TILE_ITEMS), ("l1", L1_TILE_ITEMS),
                   ("l1", L1_WIDE_TILE_ITEMS)):
        trb, tnb = merge_tile_coordinates(ob.row_end_offsets,
                                          cb_.num_nonzeros, T)
        bargs = (ob.values, ob.col_indices, ob.row_end_offsets, xb, trb,
                 tnb, T)
        band_ms[f"{pol} {T}"] = event_ms(lambda: K.merge_csrmv(
            *bargs, tickets=ob.tickets, policy=pol), iters=20)
    lib_b = M.library_csr(ob)
    b_lib = event_ms(lambda: torch.mv(lib_b, xb), iters=20)
    pick = f"{ob.plan.policy} {ob.plan.tile_items}"
    print(f"skew band: banded_n1024k_bw128_d5 {cb_.num_rows} rows "
          f"{cb_.num_nonzeros} nnz picks {pick} (tile sectors "
          f"{tile_sectors(cb_.num_rows, cb_.col_indices):.1f}, "
          f"{gather_sectors_per_nonzero(cb_.col_indices):.3f} a nonzero "
          f"per warp request); K1 ms "
          f"{ {k: round(v, 5) for k, v in band_ms.items()} } beside "
          f"cuSPARSE {b_lib:.4f} (the pick: {band_ms[pick] / b_lib:.3f}x); "
          f"verified {band_ok}")
    if not band_ok:
        return 1
    del cb_, ob, xb, lib_b

    # ------------------------------------------------------------ headline
    # python -m merge_spmv_tpu_torch.bench.headline: bench.py's JSON line
    t_phase = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_DIR + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "merge_spmv_tpu_torch.bench.headline"],
        cwd=REPO_DIR, env=env, capture_output=True, text=True, timeout=900)
    head_lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not head_lines:
        print(f"headline failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
        return 1
    print(head_lines[-1])
    headline = json.loads(head_lines[-1])
    missing = [k for k in HEADLINE_KEYS if k not in headline]
    errors = [k for k in headline if k.endswith("_error")]
    print(f"headline: {len(HEADLINE_KEYS) - len(missing)}/"
          f"{len(HEADLINE_KEYS)} of bench.py's keys, missing "
          f"{missing or 'none'}, error keys {errors or 'none'}; "
          f"{headline['value']:.2f} GFLOP/s, {headline['pct_peak']:.1f}% "
          f"of {max(info['peak_hbm_gbps'], headline['stream_gbps']):.0f} "
          f"GB/s; vs_baseline {headline['vs_baseline']:.3f}; natural skew "
          f"ratio {headline['skew_powerlaw_over_uniform_per_nnz_natural']:.3f}"
          f"; {time.perf_counter() - t_phase:.1f} s")
    if missing or errors:
        return 1

    # ------------------------------------------------------------ solvers
    # the regularised grid3d(100) Laplacian (7 diagonals), float32, each
    # solve checked against a float64 computation on the host with SciPy
    t_phase = time.perf_counter()
    lap = regularised_laplacian(100)
    n3 = lap.num_rows
    lap64 = scipy_csr(lap)
    b = np.random.RandomState(40).uniform(-1, 1, n3).astype(np.float32)
    b64 = b.astype(np.float64)
    bd = torch.from_numpy(b).to(dev)

    def rel_residual(A64, x):
        x64 = x.double().cpu().numpy()
        return float(np.linalg.norm(b64 - A64 @ x64) / np.linalg.norm(b64))

    op_lm = build_operator(lap)
    op_ld = build_dia_operator(lap)
    # the lower off-diagonals halved: nonsymmetric, diagonally dominant
    lower = lap.col_indices < lap.row_ids()
    lap_ns = lap.astype(np.float32)
    lap_ns.values = np.where(lower, 0.5 * lap.values, lap.values).astype(
        np.float32)
    op_ln = build_operator(lap_ns)
    on_diag = lap.col_indices == lap.row_ids()    # one per row, in order
    diag_l = torch.from_numpy(lap.values[on_diag]).to(dev)
    v0 = torch.from_numpy(np.random.RandomState(41).standard_normal(
        n3).astype(np.float32)).to(dev)
    ns64 = scipy_csr(lap_ns)

    def residual(A64):
        def check(out):
            res = rel_residual(A64, out[0])
            ok = res <= RESIDUAL_MAX
            return ok, (f"relative residual {res:.3e} (at most "
                        f"{RESIDUAL_MAX}) {ok}")
        return check

    def eigenvalue(out):
        # the largest eigenvalue of D - A on the 3D grid of paths P_100 is
        # 3 (2 + 2 cos(pi/100)); L adds 1
        lam, v = float(out[0]), out[1].double().cpu().numpy()
        lam_max = 7.0 + 6.0 * np.cos(np.pi / 100)
        rq = float(v @ (lap64 @ v) / (v @ v))
        eig_rel = abs(lam - lam_max) / lam_max
        rq_rel = abs(lam - rq) / abs(rq)
        ok = eig_rel <= EIG_REL_MAX and rq_rel <= RAYLEIGH_REL_MAX
        return ok, (f"eigenvalue {lam:.6f}: {eig_rel:.2e} from {lam_max:.6f}"
                    f" (at most {EIG_REL_MAX}), {rq_rel:.2e} from its "
                    f"vector's float64 Rayleigh quotient (at most "
                    f"{RAYLEIGH_REL_MAX}) {ok}")

    k1, k3 = {"merge_tile_fused": 1}, {"dia_matvec": 1}
    fused_cg = {"cg_pap": 1, "cg_update": 1, "cg_direction": 1}
    # (path, name, solve(graph, check_every), operator, launches before
    # the loop and per iteration, check_every, check)
    specs = [
        ("cg_merge", "cg over merge",
         lambda g, c: SV.conjugate_gradient(op_lm, bd, tol=SOLVER_TOL,
                                            maxiter=1000, check_every=c,
                                            graph=g),
         op_lm, k1, {**k1, **fused_cg}, 16, residual(lap64)),
        ("cg_dia", "cg over dia",
         lambda g, c: SV.conjugate_gradient(op_ld, bd, tol=SOLVER_TOL,
                                            maxiter=1000, check_every=c,
                                            graph=g),
         op_ld, k3, {**k3, **fused_cg}, 16, residual(lap64)),
        ("jacobi", "jacobi over merge",
         lambda g, c: SV.jacobi(op_lm, diag_l, bd, tol=SOLVER_TOL,
                                maxiter=1000, check_every=c, graph=g),
         op_lm, {}, k1, 16, residual(lap64)),
        ("power", "power iteration over merge",
         lambda g, c: SV.power_iteration(op_lm, v0=v0, tol=POWER_TOL,
                                         maxiter=POWER_MAXITER,
                                         check_every=c, graph=g),
         op_lm, {}, k1, 16, eigenvalue),
        # 10 iterations: blocks of 4, so that some replay
        ("bicgstab", "bicgstab over merge (lower off-diagonals halved)",
         lambda g, c: SV.bicgstab(op_ln, bd, tol=SOLVER_TOL, maxiter=1000,
                                  check_every=c, graph=g),
         op_ln, k1, {"merge_tile_fused": 2}, 4, residual(ns64)),
    ]
    paths_sv, solvers_ok = {}, (op_ld.offsets.size == 7
                                and op_ld.rest_op is None)
    print(f"solvers: L = D - A + I on grid3d(100), {lap.num_nonzeros} nnz; "
          f"{op_ld.describe()}")
    for path, name, solve, op_s, init, per_iter, every, check in specs:
        out, rep_ = run_solver(name, lambda g: solve(g, every),
                               (K, DK, CG), init, every)
        ok, text = check(out)
        ok = (ok and rep_["graph_equals_eager"]
              and rep_["launches_per_iteration"] == per_iter)
        print(solver_line(rep_, chained_rate_ms(op_s, bd), text))
        paths_sv[path] = rep_["launches"]
        solvers_ok &= ok
        del out
    ok, text, cg_fused = fused_cg_report(SV, CG, info["peak_hbm_gbps"])
    print(text)
    solvers_ok &= ok
    ok, text, mg_pcg = multigrid_report(SV, CG, info["peak_hbm_gbps"])
    print(text)
    solvers_ok &= ok
    print(f"solvers phase: {time.perf_counter() - t_phase:.1f} s")
    if not solvers_ok:
        return 1
    del lap, lap64, lap_ns, ns64, op_lm, op_ld, op_ln, v0

    # ------------------------------------------------------------ 8 driver
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = run_benchmark({"grid2d": 1000, "fp32": True, "i": 32,
                                 "backends": ["scipy", "xla", "merge",
                                              "dia", "split", "hotcold"]})
    driver_s = time.perf_counter() - t0
    summary = ", ".join(f"{b} {r['avg_ms']:.4f} ms verified={r['verified']}"
                        for b, r in results.items())
    print(f"driver: run_benchmark grid2d(1000) in {driver_s:.1f} s: "
          f"{summary}")
    if (sorted(results) != ["dia", "hotcold", "merge", "scipy", "split",
                            "xla"]
            or not all(r["verified"] for r in results.values())):
        print(out.getvalue())
        return 1

    # ------------------------------------------------------------ gather
    # the L2 sector rate a scattered gather meets (tools/gather_rate.py)
    t_phase = time.perf_counter()
    gx = torch.from_numpy(np.random.RandomState(8).uniform(
        -1, 1, 1000).astype(np.float32)).to(dev)
    gi = torch.from_numpy(np.random.RandomState(9).randint(
        0, 1000, 100_003).astype(np.int32)).to(dev)
    gk = GR.gather_sum(gx, gi, 3)
    gp = GR.gather_sum_plain(gx, gi, 3 * GR.THREADS)
    probe_same = bool(torch.equal(gk, gp))
    GR.reset_launches()
    grates = GR.measure()
    gather_launches = GR.LAUNCHES["gather_rate"]
    gbig = grates[str(GR.SIZES[0])]
    gidx = torch.randint(0, GR.SIZES[0], (GR.COUNT,), device=dev,
                         dtype=torch.int32)
    gxx = torch.rand(GR.SIZES[0], device=dev)
    gfull = GR.gather_sum(gxx, gidx)
    t0 = time.perf_counter()
    gfull_plain = GR.gather_sum_plain(gxx, gidx, gfull.shape[0])
    torch.cuda.synchronize()
    gather_plain_ms = (time.perf_counter() - t0) * 1e3
    gather_err = float((gfull - gfull_plain).abs().max())
    gather_bound = (GR.COUNT * 4 + gfull.shape[0] * 4 + GR.SIZES[0] * 4) \
        / peak_gbps / 1e6
    del gidx, gxx, gfull, gfull_plain
    for size, r in grates.items():
        print(f"gather probe: x {r['x_bytes']} B, {r['count']} reads: random "
              f"{r['random_ms']:.4f} ms ({r['reads_per_ns']:.1f} reads per "
              f"ns, {r['sector_rate_gbps']:.0f} GB/s of 32-byte sectors with "
              f"the index stream taken off at the HBM peak), coalesced "
              f"{r['coalesced_ms']:.4f} ms")
    print(f"gather probe: kernel vs plain bitwise equal {probe_same}, at "
          f"full size max|err| {gather_err:.3e} (plain {gather_plain_ms:.1f} "
          f"ms); {time.perf_counter() - t_phase:.1f} s")
    if not probe_same or gather_err != 0.0:
        return 1

    # ------------------------------------------------------------ 9 split main
    # circuit5M class at full size (tools/bench_large.py:90-96), through
    # the device-built 16-band split: one stacked fused launch per op(x)
    t_phase = time.perf_counter()
    rows_c, cols_c, vals_c = make_circuit_like(CIRCUIT_ROWS, CIRCUIT_NNZ,
                                               seed=0)
    circ = CsrMatrix.from_coo(CooMatrix(CIRCUIT_ROWS, CIRCUIT_ROWS, rows_c,
                                        cols_c, vals_c)).astype(np.float32)
    del rows_c, cols_c, vals_c
    mc, nnz_c = circ.num_rows, circ.num_nonzeros
    gen_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    rec_c = suggest_backend(circ)
    suggest_s = time.perf_counter() - t0
    print(f"split main: circuit5M class {mc} rows {nnz_c} nnz float32 "
          f"(generated in {gen_s:.1f} s); suggest_backend "
          f"({suggest_s:.1f} s): {rec_c}")
    rc = np.random.RandomState(1)
    xc = rc.uniform(0.1, 1.0, mc).astype(np.float32)
    yc0 = rc.uniform(-1, 1, mc).astype(np.float32)
    Xc = rc.uniform(-1, 1, (mc, 2)).astype(np.float32)
    xcd = torch.from_numpy(xc).to(dev)
    yc0d = torch.from_numpy(yc0).to(dev)

    op_cm = build_operator(circ)
    K.reset_launches()
    ycm = op_cm(xcd)
    torch.cuda.synchronize()
    paths["circuit5M"] = K.LAUNCHES["merge_tile_fused"]
    merge_c_ok = (verified(ycm, circ, xc) and paths["circuit5M"] == 1
                  and bool(torch.equal(op_cm(xcd), ycm)))
    merge_c = (chained_rate_ms(op_cm, xcd), chained_rate_ms(op_cm, xcd,
                                                            graph=False))
    csr_tc = torch.sparse_csr_tensor(
        torch.from_numpy(circ.row_offsets.astype(np.int32)).to(dev),
        op_cm.col_indices, op_cm.values, size=(mc, mc))
    cusparse_c_ms = event_ms(lambda: torch.mv(csr_tc, xcd))
    merge_c_bound = csr_bytes(mc, mc, nnz_c) / peak_gbps / 1e6
    print(f"circuit5M merge op(x): {merge_c[0]:.4f} ms on the device, "
          f"{merge_c[1]:.4f} eager, cuSPARSE {cusparse_c_ms:.4f} "
          f"({merge_c[0] / cusparse_c_ms:.3f}x), one launch, verified and "
          f"bitwise repeatable {merge_c_ok}")
    k1_c, k1_c_ok = k1_report("circuit5M", circ, op_cm, xcd, K, GR, grates,
                              peak_gbps, flush, flush_ms,
                              lambda: torch.mv(csr_tc, xcd))
    k1_c["launches"] = paths["circuit5M"]
    if not (merge_c_ok and k1_c_ok):
        return 1
    del op_cm, ycm

    op_s = S.build_split_operator_device(circ)
    K.reset_launches()
    ys = op_s(xcd)
    ys_ab = op_s(xcd, y_in=yc0d, alpha=1.5, beta=-0.5)
    Ys = op_s.mm(torch.from_numpy(Xc).to(dev))
    torch.cuda.synchronize()
    split_launches = dict(K.LAUNCHES)
    checks = {"op(x)": verified(ys, circ, xc),
              "op(x,y_in,1.5,-0.5)": verified(ys_ab, circ, xc, yc0, 1.5,
                                               -0.5)}
    for k in range(Xc.shape[1]):
        checks[f"mm[:, {k}]"] = verified(Ys[:, k], circ, Xc[:, k])
    bad = [k for k, ok in checks.items() if not ok]
    xr = torch.from_numpy(rc.uniform(-1, 1, mc).astype(np.float32)).to(dev)
    split_same = bool(torch.equal(op_s(xr), op_s(xr)))
    split_one = split_launches == {"merge_tile": 0, "merge_tile_fused": 2,
                                   "carry_fixup": 0, "merge_tile_mm": 1}
    sp = op_s.plan
    print(f"split main: {op_s.describe()}, m_pad {op_s._m_pad}, stack "
          f"{sp.num_rows} rows {sp.num_nonzeros} merge nonzeros "
          f"(tile_items {sp.tile_items}, {sp.num_tiles} tiles); setup_ms "
          f"{op_s.setup_ms:.1f} (upload {op_s.upload_ms:.1f}, convert "
          f"{op_s.convert_ms:.1f}), stage_ms {op_s.stage_ms}; launches "
          f"{split_launches} (one fused launch per op(x), one K1m launch "
          f"for op.mm: {split_one}), verified {len(checks) - len(bad)}/{len(checks)}"
          f"{' FAILED ' + str(bad) if bad else ''}; two op(x) calls "
          f"bitwise equal: {split_same}; merge op(x) verified {merge_c_ok}")
    if bad or not split_one or not split_same or not merge_c_ok:
        return 1

    split_dev = (chained_rate_ms(op_s, xcd), chained_rate_ms(op_s, xcd,
                                                             graph=False))
    so = op_s.op
    stack_ms = event_ms(lambda: K.merge_csrmv(
        so.values, so.col_indices, so.row_end_offsets, xcd, so.tile_rows,
        so.tile_nnz, sp.tile_items, tickets=so.tickets,
        policy=sp.policy))
    nb_c = op_s.num_bands
    split_bytes = (csr_bytes(sp.num_rows, mc, sp.num_nonzeros)
                   + nb_c * mc * 4 + mc * 4)
    split_bound = split_bytes / peak_gbps / 1e6
    paths["split"] = split_launches["merge_tile_fused"]
    mm_paths["split"] = split_launches["merge_tile_mm"]
    del op_s, so, ys, ys_ab, Ys

    # the host builder (geometric (8, 32) edges), full rows and compact
    host_split = {}
    for name, kw in (("host", {}), ("compact", {"compact_rows": True})):
        t0 = time.perf_counter()
        op_h = S.build_split_operator(circ, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ok = (verified(op_h(xcd), circ, xc)
              and verified(op_h(xcd, y_in=yc0d, alpha=1.5, beta=-0.5), circ,
                           xc, yc0, 1.5, -0.5))
        hp = op_h.plan
        hb = csr_bytes(hp.num_rows, mc, hp.num_nonzeros) + mc * 4
        hb += (op_h._gather_idx.numel() * 8 + mc * 4 if kw
               else op_h.num_bands * mc * 4)
        host_split[name] = (op_h.describe(), build_s, ok,
                            chained_rate_ms(op_h, xcd),
                            chained_rate_ms(op_h, xcd, graph=False),
                            hb / peak_gbps / 1e6, hp.num_rows)
        del op_h
    t0 = time.perf_counter()
    op_r, rec = build_suggested(circ)
    router["circuit5M"] = (rec["backend"], verified(op_r(xcd), circ, xc),
                           chained_rate_ms(op_r, xcd), merge_c[0],
                           time.perf_counter() - t0)
    del op_r
    print(f"split timing: device-built {nb_c} bands op(x) "
          f"{split_dev[0]:.4f} ms on the device (CUDA graph), "
          f"{split_dev[1]:.4f} ms eager, of which the stacked fused kernel "
          f"{stack_ms:.4f} ms; bytes bound {split_bound:.4f} ms for "
          f"{split_bytes} B; merge op(x) {merge_c[0]:.4f} ms device, "
          f"{merge_c[1]:.4f} eager, bound {merge_c_bound:.4f}; cuSPARSE "
          f"{cusparse_c_ms:.4f}; split / merge {split_dev[0] / merge_c[0]:.3f}"
          f" (byte-model ratio {split_bound / merge_c_bound:.3f})")
    for name, (desc, build_s, ok, d_ms, e_ms, bnd, rows) in host_split.items():
        print(f"split {name} builder: {desc}, {rows} stacked rows, built in "
              f"{build_s:.1f} s, verified {ok}; op(x) {d_ms:.4f} ms device, "
              f"{e_ms:.4f} eager, bytes bound {bnd:.4f}")
    print(f"split phase: {time.perf_counter() - t_phase:.1f} s")
    if not all(h[2] for h in host_split.values()):
        return 1
    del csr_tc

    # ------------------------------------------------------------ distributed
    # two ranks of parallel/mp_worker.py on this one card over gloo
    # (NCCL refuses two ranks on one GPU): grid3d(100) in halo mode on
    # the split path, with its timeline (``evidence``), and the circuit5M
    # class with the halo turned off (its +-64K columns would take halo
    # mode at S = 2), so both x modes run.  The matrices are made here
    # once and handed over as .npy files; each rank verifies its windows
    # against gold and the unsplit call, and times its K1 launches, its
    # split call and the unsplit one.  The ranks share the card, so no
    # multi-GPU number is claimed.
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as cases_dir:
        g3 = CsrMatrix.from_coo(CooMatrix.grid3d(100)).astype(np.float32)
        rd = np.random.RandomState(50)
        g3.values = rd.uniform(0.5, 1.5, g3.num_nonzeros).astype(np.float32)
        MPW.save_case(cases_dir, "grid3d100", g3,
                      rd.uniform(0.1, 1.0, g3.num_cols).astype(np.float32),
                      {"prepared": True, "evidence": True, "calls": 10})
        MPW.save_case(cases_dir, "circuit5M", circ, xc,
                      {"prepared": True, "allow_halo_x": False,
                       "calls": 5})
        del g3
        write_s = time.perf_counter() - t_phase
        dist_reps = MPW.spawn(2, cases_dir, "cuda")   # raises on a failure
    dist_ok = True
    for name, mode in (("grid3d100", "halo"), ("circuit5M", "replicate")):
        for r, rep_ in enumerate(dist_reps):
            c = rep_[name]
            print(f"distributed {name} rank {r}/2: {c['x_mode']} x (halo "
                  f"{c['halo']}, cpad {c['cpad']}), {c['local_nnz']} local "
                  f"nnz, {c['rows_checked']} rows verified against gold "
                  f"and the unsplit call, gather {c['gather']}, K1 "
                  f"launches {c['k1_launches']} ({c['k1_per_call']} a "
                  f"call), collectives a call {c['collectives_per_call']}; "
                  f"split call {c['call_ms']:.4f} ms eager, unsplit "
                  f"{c['unsplit_ms']:.4f} (exchanges through the host); "
                  f"K1 {c['k1_ms']:.4f} ms (unsplit window, CUDA graph), "
                  f"interior {c['interior_k1_ms']:.4f}; alone: the local "
                  f"SpMV {c['local_ms']:.4f} ms eager, the carries "
                  f"{c['carry_ms']:.4f} ms; partitioned in "
                  f"{c['partition_s']:.1f} s, timed in "
                  f"{c['timings_s']:.1f} s, timeline "
                  f"{c.get('evidence_s', 0.0):.1f} s")
            dist_ok &= c["x_mode"] == mode and c["k1_launches"] >= 1
            if mode != "halo":
                continue
            ev = c["evidence"]
            t = ev["calls"][-1]
            cupti = ev["cupti"]
            print(f"distributed {name} rank {r}/2 split: {c['boundary_items']}"
                  f" boundary items on {c['boundary_rows']} rows (K1 "
                  f"{c['boundary_k1_ms']:.4f} ms, gather "
                  f"{c['boundary_gather']} at {c['boundary_tile_items']}; "
                  f"compact form {c['boundary_compact_ms']:.4f} ms), "
                  f"{c['interior_nnz']} interior; exchange alone "
                  f"{c['exchange_ms']:.4f} ms; overlap_scheduled "
                  f"{ev['overlap_scheduled']} (CUPTI: "
                  f"{cupti.get('overlap_scheduled')}, {cupti['kernels_seen']}"
                  f" K1 kernels seen); last timeline, ms from the interior "
                  f"K1's start: interior end {t['interior_end']:.4f}, "
                  f"exchange {t['exchange_post']:.4f}-"
                  f"{t['exchange_done']:.4f}, halo landed "
                  f"{t['halo_landed']:.4f}, boundary "
                  f"{t['boundary_start']:.4f}-{t['boundary_end']:.4f}, "
                  f"carries done {t['carry_done']:.4f}")
            dist_ok &= (c["k1_per_call"] == 2 and c["boundary_items"] > 0
                        and c["collectives_per_call"] == 2
                        and ev["overlap_scheduled"] is True)
    paths["distributed"] = sum(c["k1_launches"] for rep_ in dist_reps
                               for c in rep_.values())
    print(f"distributed phase: both ranks PASS on both matrices, split "
          f"path checks {dist_ok}; cases written in {write_s:.1f} s; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not dist_ok:
        return 1

    # ------------------------------------------------------------ 10 hotcold
    # kron class: R-MAT scale 20, 50M generated nonzeros
    # (tools/bench_hotcold.py:43-56), through the hot/cold split
    t_phase = time.perf_counter()
    r_k, c_k, v_k = rmat(20, KRON_NNZ, 16, np.float32)
    nk_ = int(max(r_k.max(), c_k.max())) + 1
    kron = CsrMatrix.from_coo(CooMatrix(nk_, nk_, r_k, c_k, v_k)
                              ).astype(np.float32)
    del r_k, c_k, v_k
    gen_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    rec_k = suggest_backend(kron)
    suggest_s = time.perf_counter() - t0
    nnz_k = kron.num_nonzeros
    print(f"hotcold main: kron class {nk_} rows {nnz_k} nnz float32 "
          f"(generated in {gen_s:.1f} s); suggest_backend ({suggest_s:.1f} "
          f"s): {rec_k}")
    rk = np.random.RandomState(1)
    xk = rk.uniform(0.5, 1.5, nk_).astype(np.float32)
    yk0 = rk.uniform(-1, 1, nk_).astype(np.float32)
    xkd = torch.from_numpy(xk).to(dev)
    op_km = build_operator(kron)
    K.reset_launches()
    ykm = op_km(xkd)
    torch.cuda.synchronize()
    paths["kron"] = K.LAUNCHES["merge_tile_fused"]
    merge_k_ok = (verified(ykm, kron, xk) and paths["kron"] == 1
                  and bool(torch.equal(op_km(xkd), ykm)))
    merge_k = (chained_rate_ms(op_km, xkd), chained_rate_ms(op_km, xkd,
                                                            graph=False))
    csr_tk = torch.sparse_csr_tensor(
        torch.from_numpy(kron.row_offsets.astype(np.int32)).to(dev),
        op_km.col_indices, op_km.values, size=(nk_, nk_))
    cusparse_k_ms = event_ms(lambda: torch.mv(csr_tk, xkd))
    merge_k_bound = csr_bytes(nk_, nk_, nnz_k) / peak_gbps / 1e6
    print(f"kron merge op(x): {merge_k[0]:.4f} ms on the device, "
          f"{merge_k[1]:.4f} eager, cuSPARSE {cusparse_k_ms:.4f} "
          f"({merge_k[0] / cusparse_k_ms:.3f}x), one launch, verified and "
          f"bitwise repeatable {merge_k_ok}")
    k1_k, k1_k_ok = k1_report("kron", kron, op_km, xkd, K, GR, grates,
                              peak_gbps, flush, flush_ms,
                              lambda: torch.mv(csr_tk, xkd))
    k1_k["launches"] = paths["kron"]
    if not (merge_k_ok and k1_k_ok):
        return 1
    del op_km, csr_tk, ykm

    t0 = time.perf_counter()
    op_hc = S.build_hotcold_operator(kron)
    torch.cuda.synchronize()
    hc_build_s = time.perf_counter() - t0
    K.reset_launches()
    yh = op_hc(xkd)
    yh_ab = op_hc(xkd, y_in=torch.from_numpy(yk0).to(dev), alpha=1.5,
                  beta=-0.5)
    torch.cuda.synchronize()
    hc_launches = dict(K.LAUNCHES)
    hc_ok = (verified(yh, kron, xk)
             and verified(yh_ab, kron, xk, yk0, 1.5, -0.5))
    hc_same = bool(torch.equal(op_hc(xkd), op_hc(xkd)))
    hc_two = (op_hc.hot_op is not None and op_hc.cold_op is not None
              and hc_launches == {"merge_tile": 0, "merge_tile_fused": 4,
                                  "carry_fixup": 0, "merge_tile_mm": 0})
    paths["hotcold"] = hc_launches["merge_tile_fused"]
    hc = (chained_rate_ms(op_hc, xkd), chained_rate_ms(op_hc, xkd,
                                                       graph=False))
    hot_slots = op_hc.num_hot_windows * 128
    hc_bytes = (csr_bytes(nk_, hot_slots, op_hc.hot_nnz)
                + hot_slots * 4 * 2                     # x gathered, written
                + csr_bytes(nk_, nk_, op_hc.cold_nnz) + nk_ * 4)  # y_in read
    hc_bound = hc_bytes / peak_gbps / 1e6
    print(f"hotcold main: {op_hc.describe()}, built in {hc_build_s:.1f} s; "
          f"launches {hc_launches} (two fused launches per op(x): "
          f"{hc_two}), verified op(x) and op(x,y_in,1.5,-0.5) {hc_ok}, two "
          f"op(x) calls bitwise equal {hc_same}; merge op(x) verified "
          f"{merge_k_ok}")
    print(f"hotcold timing: op(x) {hc[0]:.4f} ms on the device (CUDA "
          f"graph), {hc[1]:.4f} ms eager, bytes bound {hc_bound:.4f} for "
          f"{hc_bytes} B; merge op(x) {merge_k[0]:.4f} ms device, "
          f"{merge_k[1]:.4f} eager, bound {merge_k_bound:.4f}; cuSPARSE "
          f"{cusparse_k_ms:.4f}; hotcold / merge {hc[0] / merge_k[0]:.3f}")
    if not (hc_ok and hc_two and hc_same and merge_k_ok):
        return 1
    del op_hc, yh, yh_ab
    t0 = time.perf_counter()
    op_r, rec = build_suggested(kron)
    router["kron"] = (rec["backend"], verified(op_r(xkd), kron, xk),
                      chained_rate_ms(op_r, xkd), merge_k[0],
                      time.perf_counter() - t0)
    del op_r, xkd
    print(f"hotcold phase: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------------ large tools
    # the circuit- and kron-class benchmark tools' run() on the two
    # matrices above and the circuit class's quarter, the sweep and the
    # compact run cut to B = 16; each record held to its JAX keys
    # (bench/measure.py::record_faults: every key, every entry verified,
    # no error)
    t_phase = time.perf_counter()
    K.reset_launches()
    large = {}
    t0 = time.perf_counter()
    large["bench_large"] = (BL.run(sweep=(16,), device=dev, csr=circ),
                            BL.record_keys((16,)))
    del circ
    large_s = {"bench_large": time.perf_counter() - t0}
    t0 = time.perf_counter()
    large["bench_hotcold"] = (BH.run(device=dev, csr=kron), BH.RECORD_KEYS)
    large_s["bench_hotcold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    large["split_compact_bench"] = (
        SCB.run(bands=(16,), device=dev, csr=BL.circuit_csr(*SCB.QUARTER)),
        SCB.record_keys((16,)))
    large_s["split_compact_bench"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    paths["large_tools"] = K.LAUNCHES["merge_tile_fused"]
    faults = {name: M.record_faults(rec, keys)
              for name, (rec, keys) in large.items()}
    bl, bh = large["bench_large"][0], large["bench_hotcold"][0]
    sc = large["split_compact_bench"][0]
    bl_hc = ("declined" if bl["hotcold"].get("declined") else
             f"{bl['hotcold']['avg_ms']:.4f} ms "
             f"({bl['hotcold']['hot_windows']} hot windows)")
    bsd = bl["split_device"]
    print(f"large tools bench_large: {bl['rows']} rows {bl['nnz']} nnz; "
          f"merge {bl['merge']['avg_ms']:.4f} ms ({bl['merge']['policy']}), "
          f"cuSPARSE (xla) {bl['xla']['avg_ms']:.4f}, merge_vs_xla_speedup "
          f"{bl['merge_vs_xla_speedup']:.4f}; split B=16 "
          f"{bl['split']['avg_ms']:.4f} ms ({bl['split']['stacked_rows']} "
          f"stacked rows), split_vs_xla_speedup "
          f"{bl['split_vs_xla_speedup']:.4f}; split_geometric "
          f"{bl['split_geometric']['avg_ms']:.4f} ms; split_device "
          f"{bsd['avg_ms']:.4f} ms, setup {bsd['split_setup_ms']:.1f} ms "
          f"(first {bsd['first_setup_ms']:.1f}); hotcold {bl_hc}; faults "
          f"{faults['bench_large'] or 'none'}; "
          f"{large_s['bench_large']:.1f} s")
    bh_hc = bh["hotcold"]
    print(f"large tools bench_hotcold: {bh['rows']} rows {bh['nnz']} nnz; "
          f"merge {bh['merge']['avg_ms']:.4f} ms ({bh['merge']['policy']}), "
          f"cuSPARSE {bh['cusparse']['avg_ms']:.4f}, "
          f"merge_vs_cusparse_speedup "
          f"{bh['merge_vs_cusparse_speedup']:.4f}; hotcold "
          + ("declined" if bh_hc.get("declined") else
             f"{bh_hc['avg_ms']:.4f} ms ({bh_hc['hot_windows']} hot "
             f"windows), hotcold_speedup {bh['hotcold_speedup']:.4f}")
          + f"; faults {faults['bench_hotcold'] or 'none'}; "
          f"{large_s['bench_hotcold']:.1f} s")
    sca, scc = sc["attribution"], sc["configs"]["B16_compact"]
    print(f"large tools split_compact_bench: {sc['matrix']}; B16 compact "
          f"{scc['avg_ms']:.4f} ms ({scc['stacked_rows']} stacked rows): "
          f"the stacked kernel alone {sca['B16_kernel_only_ms']:.4f}, the "
          f"re-expansion alone {sca['B16_epilogue_only_ms']:.4f}; plain "
          f"B16 {sca['plain_B16_total_ms']:.4f} ms "
          f"({sca['plain_B16_stacked_rows']} stacked rows); faults "
          f"{faults['split_compact_bench'] or 'none'}; "
          f"{large_s['split_compact_bench']:.1f} s")
    print(f"large tools phase: K1 launches {paths['large_tools']}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if any(faults.values()) or paths["large_tools"] == 0:
        return 1
    del large, bl, bh, sc

    # ------------------------------------------------------------ pagerank
    # the kron class as a 0/1 link graph (row -> column), its
    # column-stochastic transpose P[c, r] = 1 / outdeg(r) built on the card
    # by pagerank_operator in float32 and applied through K1, against a
    # float64 run of the same iterations on the host with SciPy
    t_phase = time.perf_counter()
    links = CsrMatrix(nk_, nk_, kron.row_offsets, kron.col_indices,
                      np.ones(kron.num_nonzeros, np.float32))
    adj = scipy_csr(links)
    pt = adj.T.tocsr()
    del adj
    outdeg = np.diff(kron.row_offsets).astype(np.float64)
    pt.data = 1.0 / outdeg[pt.indices]
    del kron
    op_pr = pagerank_operator(links, dtype="float32")
    del links
    pr_op_ms = chained_rate_ms(op_pr, torch.full((nk_,), 1.0 / nk_,
                                                 device=dev))
    (pr, _), rep_ = run_solver(
        "pagerank over merge (kron class)", lambda g: SV.pagerank(
            op_pr, tol=PAGERANK_TOL, maxiter=200, check_every=4, graph=g),
        (K,), {}, check_every=4)
    t0 = time.perf_counter()
    pr64 = np.full(nk_, 1.0 / nk_)
    for _ in range(rep_["iterations"]):
        spread = pt @ pr64
        pr64 = 0.85 * (spread + (1.0 - spread.sum()) / nk_) + 0.15 / nk_
    ref_s = time.perf_counter() - t0
    l1 = float(np.abs(pr.double().cpu().numpy() - pr64).sum())
    ok_pr = (l1 <= PAGERANK_L1_MAX and rep_["graph_equals_eager"]
             and rep_["iterations"] < 200
             and rep_["launches_per_iteration"] == {"merge_tile_fused": 1})
    print(solver_line(rep_, pr_op_ms, f"{op_pr.plan.num_nonzeros} nnz, "
                      f"{op_pr.plan.describe()}; L1 distance {l1:.3e} from "
                      f"the float64 run (at most {PAGERANK_L1_MAX}; "
                      f"{ref_s:.1f} s on the host), tol {PAGERANK_TOL} "
                      f"reached {rep_['iterations'] < 200}: {ok_pr}"))
    paths_sv["pagerank"] = rep_["launches"]
    print(f"pagerank phase: {time.perf_counter() - t_phase:.1f} s")
    if not ok_pr:
        return 1
    del pt, op_pr, pr, pr64, outdeg

    # ------------------------------------------------------------ 11 router
    # build_suggested on each class (the circuit and kron rows above), each
    # pick verified and timed against merge op(x) on the same matrix
    t_phase = time.perf_counter()
    g3 = CsrMatrix.from_coo(CooMatrix.grid3d(100)).astype(np.float32)
    rl = np.random.RandomState(5)                  # tests/test_suggest.py:48
    n_l = 50_000
    rows_l = np.repeat(np.arange(n_l, dtype=np.int64), 8)
    cols_l = np.clip(rows_l + rl.randint(-2048, 2049, rows_l.size), 0,
                     n_l - 1)
    local = CsrMatrix.from_coo(CooMatrix(n_l, n_l, rows_l, cols_l,
                                         rl.uniform(-1, 1, rows_l.size))
                               ).astype(np.float32)
    for name, c in (("grid3d100", g3), ("local_uniform", local)):
        xv = np.random.RandomState(2).uniform(0.5, 1.5, c.num_cols).astype(
            np.float32)
        xvd = torch.from_numpy(xv).to(dev)
        t0 = time.perf_counter()
        op_r, rec = build_suggested(c)
        build_s = time.perf_counter() - t0
        router[name] = (rec["backend"], verified(op_r(xvd), c, xv),
                        chained_rate_ms(op_r, xvd),
                        chained_rate_ms(build_operator(c), xvd), build_s)
    want = {"grid3d100": "dia", "circuit5M": "split", "kron": "hotcold",
            "local_uniform": "merge"}
    for name, (backend, ok, r_ms, m_ms, build_s) in router.items():
        print(f"router {name}: {backend} (the JAX package's class answer "
              f"{want[name]}), verified {ok}, op(x) {r_ms:.4f} ms vs merge "
              f"op(x) {m_ms:.4f} ({r_ms / m_ms:.3f}x), built in "
              f"{build_s:.1f} s")
    print(f"router phase: {time.perf_counter() - t_phase:.1f} s")
    if not all(r[1] for r in router.values()):
        return 1

    # ------------------------------------------------------------ 12 autotune
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tune_dir:
        os.environ[A.CACHE_ENV] = os.path.join(tune_dir, "tune.json")
        A.reset_timed()
        op_a = build_operator(g3, autotune=True)
        timed_first = A.TIMED["candidates"]
        with open(A.cache_path()) as f:
            entries = json.load(f)
        A.reset_timed()
        op_b = build_operator(g3, autotune=True)
        timed_second = A.TIMED["candidates"]
        del os.environ[A.CACHE_ENV]
    x1g = np.ones(g3.num_cols, np.float32)
    tune_ok = (verified(op_b(torch.from_numpy(x1g).to(dev)), g3, x1g)
               and op_a.plan.tile_items == op_b.plan.tile_items)
    print(f"autotune: grid3d(100) {entries}; winner tile_items "
          f"{op_a.plan.tile_items}; candidates timed by the first build "
          f"{timed_first}, by the second {timed_second}; verified {tune_ok}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if (timed_first != len(A.DEFAULT_CANDIDATES) or timed_second != 0
            or not tune_ok):
        return 1
    del op_a, op_b, g3, local

    # ------------------------------------------------------------ 13 probe
    xp = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (8, 128)).astype(np.float32)).to(dev)
    small = (5, 8, P.CHAINS, 64)   # grid, unroll, chains, table rows
    bad = []
    for cls in P.CLASSES:
        got = P.probe(cls, xp, *small)     # checks that the blocks agree
        want = P.probe_plain(cls, xp, *small)
        # fma: FFMA rounds once where the plain version rounds twice
        same = (torch.allclose(got, want, rtol=1e-5, atol=0)
                if cls == "fma" else torch.equal(got, want))
        if not same:
            bad.append(cls)
    print(f"probe small: grid {small[0]} unroll {small[1]} chains "
          f"{small[2]} table rows {small[3]}, kernel vs plain failures: "
          f"{bad or 'none'}")
    if bad:
        return 1
    sass = P.sass_loop_counts("select")
    sass_same = all(sass[k] == v for k, v in P.SASS_PER_STEP["select"].items()
                    if k in sass)
    print(f"probe select SASS of sm_ceiling_kernel<1, {P.CHAINS}>'s timed "
          f"loop: {sass}; the counts tools/sm_ceiling.py bounds with "
          f"{P.SASS_PER_STEP['select']}: the same {sass_same}")
    P.reset_launches()
    rates = P.measure(x=xp)
    probe_launches = dict(P.LAUNCHES)
    for cls in P.CLASSES:
        r = rates[cls]
        big = P.probe(cls, xp, blocks=r["blocks"])
        t0 = time.perf_counter()
        plain = P.probe_plain(cls, xp)
        torch.cuda.synchronize()
        r["plain_ms"] = (time.perf_counter() - t0) * 1e3
        r["max_abs_err"] = float((big - plain).abs().max())
        rel = r["max_abs_err"] / max(float(plain.abs().max()), 1e-30)
        # the full size's 262,144 dependent steps: fma's single rounding
        # drifts from the plain version's two (checked at 1e-2 relative);
        # every other class takes the same float32 operations
        r["ok"] = (rel <= 1e-2 if cls == "fma"
                   else r["max_abs_err"] == 0.0)
        smem = (f", smem bound {r['smem_bound_ms']:.4f} ms"
                if "smem_bound_ms" in r else "")
        if "shuffle_bound_ms" in r:
            smem += f", shuffle bound {r['shuffle_bound_ms']:.4f} ms"
        if "issue_bound_ms" in r:
            smem += (f", issue bound {r['issue_bound_ms']:.4f} ms "
                     f"({100 * r['issue_bound_ms'] / r['ms_per_launch']:.1f}"
                     f"% of it), integer-pipe bound "
                     f"{r['int_pipe_bound_ms']:.4f} ms "
                     f"({100 * r['int_pipe_bound_ms'] / r['ms_per_launch']:.1f}"
                     "%)")
        print(f"probe {cls}: {r['ms_per_launch']:.4f} ms per launch of "
              f"{r['blocks']} blocks, {r['ops_per_s']:.4e} ops/s, "
              f"{r['ops_per_sm_per_clock']:.2f} per SM per clock at "
              f"{r['sm_clock_mhz']:.0f} MHz; bound {r['bound_ms']:.4f} ms"
              f"{smem}; plain {r['plain_ms']:.1f} ms, max|err| "
              f"{r['max_abs_err']:.3e} ok={r['ok']}")
    if (not all(rates[c]["ok"] for c in P.CLASSES)
            or min(probe_launches.values()) < 1):
        return 1

    # ------------------------------------------------------------ ingest
    # one full-size .mtx (the circuit5M class at the headline's quarter
    # scale) written, parsed and turned into CSR by the native library and
    # by NumPy: bit-equal arrays, the four host times
    t_phase = time.perf_counter()
    if not NI.available():
        print(f"ingest: the native host library is unavailable: "
              f"{NI.build_error()}")
        return 1
    nq, nnzq = CIRCUIT_QUARTER
    r_q, c_q, v_q = make_circuit_like(nq, nnzq)
    with tempfile.TemporaryDirectory() as ingest_dir:
        path_q = os.path.join(ingest_dir, "circuit_quarter.mtx")
        t0 = time.perf_counter()
        MK.write_market(path_q, nq, nq, r_q, c_q, v_q)
        write_s = time.perf_counter() - t0
        size_q = os.path.getsize(path_q)
        t0 = time.perf_counter()
        got_q = NI.read_market(path_q)
        parse_native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_q = MK.read_market(path_q)
        parse_numpy_s = time.perf_counter() - t0
    # a general file: the same entry order both ways, so equal as they
    # stand (and so after a (row, col) lexsort); values bit-equal
    parse_same = (got_q[:2] == want_q[:2] == (nq, nq) and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(got_q[2:], want_q[2:])))
    parse_same = parse_same and np.array_equal(got_q[4].view(np.int64),
                                               want_q[4].view(np.int64))
    written_same = (np.array_equal(got_q[2], r_q) and np.array_equal(
        got_q[3], c_q) and np.array_equal(got_q[4], v_q))
    del want_q
    coo_q = CooMatrix(nq, nq, got_q[2], got_q[3], got_q[4])
    t0 = time.perf_counter()
    csr_nat = CsrMatrix.from_coo(coo_q, use_native=True)
    csr_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr_np = CsrMatrix.from_coo(coo_q, use_native=False)
    csr_numpy_s = time.perf_counter() - t0
    csr_same = all(np.array_equal(getattr(csr_nat, k), getattr(csr_np, k))
                   for k in ("row_offsets", "col_indices", "values"))
    print(f"ingest: circuit5M class quarter ({nq} rows, {len(v_q)} nnz), "
          f"{size_q} B .mtx written natively in {write_s:.2f} s; parse "
          f"native {parse_native_s:.2f} s, NumPy {parse_numpy_s:.2f} s "
          f"({parse_numpy_s / parse_native_s:.1f}x), arrays bit-equal "
          f"{parse_same}, equal to the generated ones {written_same}; "
          f"from_coo native {csr_native_s:.2f} s, NumPy {csr_numpy_s:.2f} s "
          f"({csr_numpy_s / csr_native_s:.1f}x), arrays equal {csr_same}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    del r_q, c_q, v_q, got_q, coo_q, csr_nat, csr_np
    if not (parse_same and written_same and csr_same):
        return 1

    # ------------------------------------------------------------ corpus
    # the mini corpus and one full-size matrix per generator family of the
    # stats corpus through tools/eval_corpus.py (one CLI process per file,
    # merge = K1 and xla = cuSPARSE), then tools/corpus_stats.py
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()   # the rows' processes share the card
    with tempfile.TemporaryDirectory() as corpus_dir:
        mtx_dir = os.path.join(corpus_dir, "mtx")
        with contextlib.redirect_stdout(io.StringIO()):
            MC.main([mtx_dir])
            MS.main([mtx_dir, "--only", ",".join(CORPUS_FULL)])
        gen_s = time.perf_counter() - t_phase
        csv_path = os.path.join(corpus_dir, "corpus.csv")
        stats_out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stats_out):
            EC.main([mtx_dir, "--out", csv_path, "--backends=merge,xla",
                     "--timeout", "300"])
        sweep_s = time.perf_counter() - t0
        with open(csv_path) as f:
            csv_lines = f.read().splitlines()
        with open(os.path.join(corpus_dir, "CORPUS_STATS.json")) as f:
            corpus_rec = json.load(f)["corpus.csv"]
    names_c = [ln.split(",")[0].strip() for ln in csv_lines
               if ln and not ln.startswith(("dataset", "#"))]
    bad_rows = [ln.split(",")[0] for ln in csv_lines
                if any(t in ln for t in ("ERROR", "TIMEOUT", "FAIL"))
                or (not ln.startswith(("dataset", "#"))
                    and "Merge CsrMV (CUDA)" not in ln)]
    corpus_k1 = 0
    for ln in csv_lines:
        parts = [q.strip() for q in ln.split(",")]
        tail = dict(q.split("=", 1) for q in parts[9:] if "=" in q)
        corpus_k1 += int(tail.get("k1_launches", 0))
        if len(parts) >= 19 and not ln.startswith("dataset"):
            print(f"corpus row {parts[0]}: nnz {parts[4]}, CoV {parts[7]}, "
                  f"{tail.get('merge_policy')}, K1 {tail.get('k1_launches')} "
                  f"launches; {parts[9]} {parts[11]} ms, {parts[14]} "
                  f"{parts[16]} ms")
    for ln in stats_out.getvalue().splitlines():
        if not ln.startswith("wrote "):
            print(f"corpus stats: {ln}")
    paths["corpus"] = corpus_k1
    ok_c = (not bad_rows and len(names_c) == CORPUS_FILES and corpus_k1 > 0
            and "merge_vs_library" in corpus_rec)
    print(f"corpus: {len(names_c)} rows ({CORPUS_FILES} files: 25 mini, "
          f"{len(CORPUS_FULL)} full-size), generated and written in "
          f"{gen_s:.1f} s, swept in {sweep_s:.1f} s; K1 launches "
          f"{corpus_k1}; rows at fault: {bad_rows or 'none'}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not ok_c:
        return 1

    # ------------------------------------------------------------ baseline
    # the north-star configurations that fit a smoke run, through the
    # benchmark tools' own functions, at their published sizes
    t_phase = time.perf_counter()
    K.reset_launches()
    DK.reset_launches()
    entries = {}
    cant64 = BC.cant_csr(np.float64)
    before = K.LAUNCHES["merge_tile_fused"]
    entries["cant_class"] = BC.run_csrmv(cant64, "float64", dev)
    # less the one launch card_spmv holds against the plain version
    cant_launches = K.LAUNCHES["merge_tile_fused"] - before - 1
    del cant64
    entries["webbase_1M_class"] = BC.run_csrmv(BC.webbase_1m_csr(),
                                               "float32", dev)
    entries.update(BC.run_spmm("cant", BC.cant_csr(np.float32), dev))
    entries.update(BC.run_spmm("pdb1HYS", BC.pdb1hys_csr(), dev))
    skew_b = SKB.run(1 << 20, 8, dev)
    mm_before = (K.LAUNCHES["merge_tile_mm"], DK.LAUNCHES["dia_matmat"])
    spmm_b = SPB.run(60, 32, dev)
    torch.cuda.synchronize()
    paths["baseline"] = K.LAUNCHES["merge_tile_fused"]
    dia_launches["baseline_spmm"] = DK.LAUNCHES["dia_matvec"]
    mm_paths["baseline_spmm"] = K.LAUNCHES["merge_tile_mm"]
    mm_paths["bench_spmm"] = K.LAUNCHES["merge_tile_mm"] - mm_before[0]
    dia_mm_paths["bench_spmm"] = DK.LAUNCHES["dia_matmat"] - mm_before[1]
    weak_b = MCB.run(1 << 17, (1, 2, 4), dev)
    weak_ranks = [r for res in (weak_b["results"], weak_b["fixed_total_work"])
                  for e in res.values() for r in e["ranks"]]
    paths["weak_scaling_ranks"] = sum(r["k1_launches"] for r in weak_ranks)
    for name, e in entries.items():
        cus = e.get("cusparse_ms", e.get("cusparse_spmm_ms"))
        k1 = (f"K1 {e['policy']} warm {e['k1_ms']} cold {e['k1_cold_ms']}"
              f", bytes bound {e['bytes_bound_ms']:.4f} ms"
              if "k1_ms" in e else
              f"eager {e['eager_ms']:.4f}, X column-major "
              f"{e['colmajor_ms']:.4f} (cuSPARSE "
              f"{e['cusparse_spmm_colmajor_ms']:.4f}); K1m alone warm "
              f"{e['k1m_ms']:.4f} cold {e['k1m_cold_ms']:.4f} (cuSPARSE "
              f"cold {e['cusparse_spmm_cold_ms']:.4f}), "
              f"{e['k1m_launches']} launch, {e['k1m_launch']}, against its "
              f"plain version max|err| {e['k1m_plain_max_abs_err']:.3e} "
              f"ok={e['k1m_plain_ok']}, plain {e['k1m_plain_ms']:.2f} ms; "
              f"column loop {e['column_loop_ms']:.4f} ms (verified "
              f"{e['column_loop_verified']}, {e['column_loop_k1_launches']} "
              f"K1 launches): op.mm "
              f"{e['column_loop_ms'] / e['avg_ms']:.2f}x faster; SpMM bound "
              f"{e['spmm_bound_ms']:.4f} ms, gather bound "
              f"{e['gather_bound_ms']:.4f} (rows at the matrix's columns "
              f"at {e['gather_rate_gbps']:.0f} GB/s; at random ones "
              f"{e['gather_rows']['random_rate_gbps']:.0f} GB/s: "
              f"{e['gather_bound_random_ms']:.4f}); column loop's bound "
              f"{e['column_loop_bound_ms']:.4f}), column copies "
              f"{e['column_copies_ms']:.4f}, stack {e['stack_ms']:.4f}")
        print(f"baseline {name}: {e['rows']} rows {e['nnz']} nnz "
              f"{e.get('dtype', 'float32')}, verified {e['verified']}; "
              f"{e['avg_ms']:.4f} ms per call ({e['timing']}), cuSPARSE "
              f"{cus:.4f}; {k1}")
    for name, e in [(n, e.get("spmv_k1", e)) for n, e in entries.items()]:
        if "plain_ok" in e:
            fp64 = (f"; float64: |y - plain| at most "
                    f"{e['plain_err_over_fp64_bound']:.3e} and |y - gold| "
                    f"{e['gold_err_over_fp64_bound']:.3e} of 2 gamma_n "
                    f"|A| |x|" if "plain_err_over_fp64_bound" in e else "")
            print(f"baseline K1 at {name} vs its plain version: max|err| "
                  f"{e['plain_max_abs_err']:.3e} ok={e['plain_ok']} (within "
                  f"the backward-error bound |A| |x|{fp64}), plain "
                  f"{e['plain_ms']:.2f} ms")
    for label in ("uniform", "powerlaw", "wheel"):
        e = skew_b[label]
        print(f"baseline skew {label}: {e['nnz']} nnz CoV {e['row_cov']:.3f} "
              f"{e['policy']}, verified {e['verified']}; op(x) "
              f"{e['avg_ms']:.4f} ms, cuSPARSE {e['cusparse_ms']:.4f}")
    print(f"baseline skew: powerlaw / uniform, the JAX tool's per-nnz "
          f"formula (uniform ms / powerlaw ms) "
          f"{skew_b['powerlaw_over_uniform_per_nnz']:.4f} (cuSPARSE "
          f"{skew_b['cusparse_powerlaw_over_uniform_per_nnz']:.4f}); time "
          f"per nonzero {skew_b['powerlaw_over_uniform_gflops']:.4f} "
          f"(cuSPARSE "
          f"{skew_b['cusparse_powerlaw_over_uniform_gflops']:.4f})")
    for part in ("column_loop", "k1m", "dia", "dia_column"):
        e = spmm_b[part]
        print(f"baseline bench_spmm grid3d(60) k=32 {part}: "
              f"{e['avg_ms']:.4f} ms graph, {e['eager_ms']:.4f} eager, "
              f"verified {e['verified']}, launches {e['launches']}")
    sd = spmm_b["dia"]
    print(f"baseline bench_spmm: cuSPARSE SpMM {spmm_b['cusparse_spmm_ms']:.4f}"
          f" ms (X column-major {spmm_b['cusparse_spmm_colmajor_ms']:.4f}),"
          f" column loop with X column-major "
          f"{spmm_b['column_loop']['colmajor_ms']:.4f} ms, SpMM bound "
          f"{spmm_b['spmm_bound_ms']:.4f} ms; K3m alone warm "
          f"{sd['k3m_ms']:.4f} cold {sd['k3m_cold_ms']:.4f}, bytes bound "
          f"{sd['bytes_bound_ms']:.4f}, against its plain version max|err| "
          f"{sd['k3m_plain_max_abs_err']:.3e} ok={sd['k3m_plain_ok']}, plain "
          f"{sd['k3m_plain_ms']:.2f} ms; DIA mm "
          f"{spmm_b['cusparse_spmm_ms'] / sd['avg_ms']:.2f}x faster than "
          f"cuSPARSE SpMM")
    for S, e in weak_b["results"].items():
        f = weak_b["fixed_total_work"][S]
        print(f"baseline weak scaling S={S} (ranks share the card): "
              f"{e['rows']} rows {e['nnz']} nnz {e['x_mode']}, verified "
              f"{e['verified']}; call {e['avg_ms']:.3f} ms (unsplit "
              f"{e['unsplit_ms']:.3f}, {e['collectives_per_call']} "
              f"collectives a call), local-only "
              f"{e['local_only_ms']:.3f}, per-rank K1 "
              f"{[round(r['k1_ms'], 4) for r in e['ranks']]}; fixed-total "
              f"{f['avg_ms']:.3f} ms verified {f['verified']}")
    base_ok = (all(e["verified"] and e.get("plain_ok", True)
                   and e.get("spmv_k1", {}).get("plain_ok", True)
                   for e in entries.values())
               and all(skew_b[k]["verified"]
                       for k in ("uniform", "powerlaw", "wheel"))
               and all(spmm_b[part]["verified"] for part in (
                   "column_loop", "k1m", "dia", "dia_column"))
               and spmm_b["dia"]["launches"]["dia_matmat"] == 1
               and spmm_b["dia"]["k3m_plain_ok"]
               and spmm_b["k1m"]["launches"]["merge_tile_mm"] == 1
               and spmm_b["k1m"]["k1m_plain_ok"]
               and all(e["column_loop_verified"] and e["k1m_plain_ok"]
                       and e["k1m_launches"] == 1
                       for name, e in entries.items()
                       if name.startswith("spmm"))
               and all(e["verified"] for part in (
                   "results", "fixed_total_work", "prepared_vs_unprepared")
                   for e in weak_b[part].values())
               and entries["cant_class"]["k1_launches"] == 1
               and "gold_err_over_fp64_bound" in entries["cant_class"]
               and "plain_err_over_fp64_bound" in entries["cant_class"]
               and cant_launches > 0
               and paths["weak_scaling_ranks"] > 0)
    print(f"baseline: K1 launches {paths['baseline']} (+ "
          f"{paths['weak_scaling_ranks']} in the ranks), K3 "
          f"{dia_launches['baseline_spmm']}, K1m {mm_paths['baseline_spmm']}"
          f", K3m {dia_mm_paths['bench_spmm']}; all verified {base_ok}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not base_ok:
        return 1
    cb = entries["cant_class"]
    k1_b = {"name": "merge_tile_fused@cant_class_f64", "route": "cuda",
            "source": "merge_spmv_tpu_torch/csrc/merge_csrmv.cu",
            "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:150",
            "launches": cant_launches,
            "max_abs_err": cb["plain_max_abs_err"],
            "ms": cb["k1_ms"][cb["policy"]], "plain_ms": cb["plain_ms"],
            "bound_ms": cb["bytes_bound_ms"], "bound_by": "bytes",
            "library_ms": cb["cusparse_ms"], "main_path": True,
            "policy": cb["policy"], "cold_ms": cb["k1_cold_ms"][cb["policy"]]}

    # ------------------------------------------------------------ fastrp k1m
    # K1m at the FastRP cell's width, on its graph (fastrp_k1m_report)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fastrp_ok, fastrp_line, fastrp_k1m, fastrp_op = \
        fastrp_k1m_report(peak_gbps)
    torch.cuda.empty_cache()
    print(f"{fastrp_line}; {time.perf_counter() - t_phase:.1f} s")
    if not fastrp_ok:
        return 1
    # FastRP's normalise-and-accumulate: solvers.fastrp on the cell's
    # operator, then the kernel at the cell's N (fastrp_normalize_report)
    t_phase = time.perf_counter()
    norm_ok, norm_line, fastrp_norm = fastrp_normalize_report(peak_gbps,
                                                             fastrp_op)
    del fastrp_op
    torch.cuda.empty_cache()
    print(f"{norm_line}; {time.perf_counter() - t_phase:.1f} s")
    if not norm_ok:
        return 1

    # ------------------------------------------------------------ pagerank cell
    # the graph500_24.pagerank cell's path: pagerank_operator's transpose,
    # K1 on its P and the cell's job (pagerank_report)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    pr_ok, pr_line, pr_cell = pagerank_report()
    torch.cuda.empty_cache()
    print(f"{pr_line}; {time.perf_counter() - t_phase:.1f} s")
    if not pr_ok:
        return 1

    # ------------------------------------------------------------ 14 report
    # main_path: false marks the unfused instantiation and the separate
    # fix-up, which op(x) no longer launches (their launches are 0 there)
    src = "merge_spmv_tpu_torch/csrc/merge_csrmv.cu"
    kernels = [
        {"name": "merge_tile_fused", "route": "cuda", "source": src,
         "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:150",
         "launches": launches["merge_tile_fused"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
         "bound_by": "bytes", "library_ms": cusparse_ms, "main_path": True,
         "launches_by_path": {**paths, **{
             k: v["merge_tile_fused"] for k, v in paths_sv.items()
             if "merge_tile_fused" in v}}},
        {"name": "merge_tile", "route": "cuda", "source": src,
         "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:150",
         "launches": launches["merge_tile"], "max_abs_err": tile_err,
         "ms": tile_ms, "plain_ms": tile_plain_ms, "bound_ms": tile_bound,
         "bound_by": "bytes", "library_ms": cusparse_ms,
         "main_path": False},
        {"name": "carry_fixup", "route": "cuda", "source": src,
         "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:919",
         "launches": launches["carry_fixup"], "max_abs_err": fix_err,
         "ms": fix_ms, "plain_ms": fix_plain_ms, "bound_ms": fix_bound,
         "bound_by": "bytes", "library_ms": index_add_ms,
         "main_path": False},
        {"name": "dia_matvec", "route": "cuda",
         "source": "merge_spmv_tpu_torch/csrc/dia_matvec.cu",
         "replaces": "merge_spmv_tpu/ops/dia_pallas.py:82",
         "launches": dia_launches["dia_matvec"], "max_abs_err": dia_err,
         "ms": dia_ms, "plain_ms": dia_plain_ms, "bound_ms": dia_bound,
         "bound_by": "bytes", "library_ms": dia_cusparse_ms,
         "main_path": True,
         "launches_by_path": {"main": dia_launches["dia_matvec"],
                              "cg_dia": paths_sv["cg_dia"]["dia_matvec"],
                              "baseline_spmm":
                                  dia_launches["baseline_spmm"]}},
    ]
    kernels += [k1_c, k1_k, k1_b, k1_w]
    # K1 on the graph500_24.pagerank cell's P in float64: launches as the
    # cell's job made them (one a step, masked steps included)
    kernels.append({"name": "merge_tile_fused@graph500_24_f64",
                    "route": "cuda", "source": src,
                    "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:150",
                    **pr_cell})
    # K1m: launches from the main phase's op.mm, by path, and per SpMM
    # config (counted around that config's op.mm); times at cant, k = 32
    mm_src = "merge_spmv_tpu_torch/csrc/merge_csrmm.cu"
    # the TPU kernel, reached for SpMM through csrmm_column_loop (:1376)
    mm_replaces = "merge_spmv_tpu/ops/csrmv_pallas.py:150"

    def k1m_entry(name, e, launches):
        return {"name": name, "route": "cuda", "source": mm_src,
                "replaces": mm_replaces, "launches": launches,
                "max_abs_err": e["k1m_plain_max_abs_err"], "ms": e["k1m_ms"],
                "plain_ms": e["k1m_plain_ms"], "bound_ms": e["spmm_bound_ms"],
                "bound_by": "bytes", "library_ms": e["cusparse_spmm_ms"],
                "main_path": True, "cold_ms": e["k1m_cold_ms"],
                "gather_bound_ms": e["gather_bound_ms"],
                "gather_bound_random_ms": e["gather_bound_random_ms"],
                "column_loop_ms": e["column_loop_ms"], "k": e["k"],
                "launch": e["k1m_launch"]}
    kernels.append({**k1m_entry("merge_tile_mm", entries["spmm_cant_k32"],
                                mm_paths["main"]),
                    "launches_by_path": mm_paths})
    kernels += [k1m_entry(f"merge_tile_mm@{name}", e, e["k1m_launches"])
                for name, e in entries.items() if name.startswith("spmm")
                and name != "spmm_cant_k32"]
    # the FastRP cell's width: four 64-column launches a product
    kernels.append({"name": "merge_tile_mm@kron_g500_logn21_sym_k256",
                    "route": "cuda", "source": mm_src,
                    "replaces": mm_replaces, **fastrp_k1m})
    # FastRP's normalise-and-accumulate, a launch a product: launches as
    # solvers.fastrp made them at the cell's weights; times of the cell's
    # three modes summed (a call); plain_ms is the torch ops'
    kernels.append({"name": "row_normalize", "route": "cuda",
                    "source": "merge_spmv_tpu_torch/csrc/row_normalize.cu",
                    "replaces": None, **fastrp_norm})
    kernels.append(
        {"name": "dia_matmat", "route": "cuda",
         "source": "merge_spmv_tpu_torch/csrc/dia_matvec.cu",
         "replaces": "merge_spmv_tpu/ops/dia_pallas.py:82",
         "launches": dia_mm_paths["main"],
         "max_abs_err": sd["k3m_plain_max_abs_err"], "ms": sd["k3m_ms"],
         "plain_ms": sd["k3m_plain_ms"], "bound_ms": sd["bytes_bound_ms"],
         "bound_by": "bytes", "library_ms": spmm_b["cusparse_spmm_ms"],
         "main_path": True, "cold_ms": sd["k3m_cold_ms"],
         "launches_by_path": dia_mm_paths})
    kernels.append(
        {"name": "gather_rate", "route": "cuda",
         "source": "merge_spmv_tpu_torch/csrc/gather_rate.cu",
         "replaces": "merge_spmv_tpu/ops/csrmv_pallas.py:150",
         "launches": 0, "max_abs_err": gather_err, "ms": gbig["random_ms"],
         "plain_ms": gather_plain_ms, "bound_ms": gather_bound,
         "bound_by": "bytes", "library_ms": None, "main_path": False,
         "probe_launches": gather_launches})
    for cls in P.CLASSES:
        r = rates[cls]
        kernels.append(
            {"name": f"sm_ceiling_{cls}", "route": "cuda",
             "source": "merge_spmv_tpu_torch/csrc/sm_ceiling.cu",
             "replaces": "tools/vpu_ceiling.py:50",
             "launches": probe_launches[cls],
             "max_abs_err": r["max_abs_err"], "ms": r["ms_per_launch"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None,
             "main_path": True})
    # CG's fused step at HPCG-104 in float64: times in the solve's own
    # sequence; plain_ms is the torch step's vector work, the three
    # kernels' plain version together
    for name, e in cg_fused["kernels"].items():
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "merge_spmv_tpu_torch/csrc/cg_step.cu",
             "replaces": "merge_spmv_tpu/models/solvers.py:56",
             "launches": e["launches"], "max_abs_err": e["max_abs_err"],
             "ulps_of_norm": e["ulps_of_norm"], "ms": e["ms"],
             "plain_ms": cg_fused["plain_ms"], "plain_of": "all three",
             "bound_ms": e["bound_ms"], "bound_by": "bytes",
             "hbm_passes": e["hbm_passes"], "l2_passes": e["l2_passes"],
             "library_ms": None, "main_path": True,
             "launches_by_path": {path: paths_sv[path][name]
                                  for path in ("cg_merge", "cg_dia")}})
    # HPCG's V-cycle and PCG's step at the hpcg_104_mg.pcg cell's shapes in
    # float64: launches as the host counted them in the cell's set, times
    # there on the card (a launch's mean over the levels; by_level each
    # level's, with the kernel and its plain version alone); the colour
    # step's plain route is its K1 product and symgs_update_plain; the PCG
    # kernels' plain_ms is the torch step's vector work, all four's
    for name, entry in (("symgs_update", "symgs_colour"),
                        ("mg_restrict", "mg_restrict"),
                        ("mg_prolong", "mg_prolong")):
        e = mg_pcg["kernels"][name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "merge_spmv_tpu_torch/csrc/multigrid.cu",
             "replaces": None, "launches": mg_pcg["host"]["kernels"][entry],
             "max_abs_err": e["max_abs_err"],
             "ulps_of_scale": e.get("ulps_of_scale"), "ms": e["ms"],
             "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
             "bound_by": "bytes", "library_ms": None, "main_path": True,
             "by_level": mg_pcg["by_level"][name]})
    for name in ("pcg_pap", "pcg_update", "pcg_rz", "cg_direction"):
        e = mg_pcg["kernels"][name]
        kernels.append(
            {"name": f"{name}@pcg" if name == "cg_direction" else name,
             "route": "cuda",
             "source": "merge_spmv_tpu_torch/csrc/cg_step.cu",
             "replaces": None, "launches": mg_pcg["host"]["cg"][name],
             "max_abs_err": None, "ulps_of_norm": e["ulps_of_norm"],
             "ms": e["ms"], "plain_ms": mg_pcg["plain_ms"],
             "plain_of": "all four", "bound_ms": e["bound_ms"],
             "bound_by": "bytes", "hbm_passes": e["hbm_passes"],
             "l2_passes": e["l2_passes"], "library_ms": None,
             "main_path": True})
    print(json.dumps({"kernels": kernels}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
