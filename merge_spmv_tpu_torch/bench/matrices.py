"""Generators of the benchmarks' matrices from a seed: the large
scattered-column classes the split operators are for and the stand-ins of
the north-star configurations, as (rows, cols, vals) COO arrays; the skew
trio and the weak-scaling matrices as CSR.

Copies of the JAX side's benchmark generators, so that the port needs
nothing of it; each draws from its RandomState in the JAX tool's order,
so that its arrays are the JAX tool's bit for bit:

* ``make_circuit_like`` — circuit5M class (tools/bench_large.py:52-71):
  power-law row degrees and Laplace column offsets off the diagonal;
  ``make_circuit_like(5_558_326, 59_524_291)`` is the full size.
* ``rmat`` — the Kronecker / R-MAT kron_g500 class
  (tools/bench_baseline_configs.py:133-147): power-law both ways,
  globally scattered columns; ``rmat(20, 50_000_000, 16, np.float32)`` is
  the hot/cold benchmark's matrix (tools/bench_hotcold.py:43-56);
* ``banded`` — the FEM-band class of cant, pdb1HYS and cage15
  (tools/bench_baseline_configs.py:93-102): deg nonzeros a row, normal
  column offsets of spread sigma;
* ``powerlaw_web`` — the webbase class (tools/bench_baseline_configs.py:
  105-130): pareto row degrees, a local / Zipf-global column mix;
* ``skew_trio`` — bench_skew's uniform, power-law and wheel matrices at
  equal nnz (tools/bench_skew.py:171-220), each with the values the JAX
  tool draws for it (:176) from the same RandomState, in between;
* ``weak_scaling_matrices`` — bench_multichip's matrix for each S in
  (1, 2, 4, 8) and its fixed-total-work matrix with their x
  (tools/bench_multichip.py:83-99, 152-160): all are drawn, in that
  order, whichever are built.
"""

from __future__ import annotations

import numpy as np

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix

__all__ = ["make_circuit_like", "rmat", "banded", "powerlaw_web",
           "skew_trio", "weak_scaling_matrices", "WEAK_SHARDS"]

# the shard counts of the weak-scaling sweep (tools/bench_multichip.py:88)
WEAK_SHARDS = (1, 2, 4, 8)


def make_circuit_like(n, nnz, seed=0):
    """Power-law row degrees + Laplace column offsets off the diagonal."""
    rs = np.random.RandomState(seed)
    # power-law-ish degrees: most rows small, a few huge (hubs)
    raw = rs.pareto(1.8, n) + 1.0
    deg = np.maximum(1, (raw * (nnz / raw.sum())).astype(np.int64))
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    m = rows.size
    # Laplace offsets around the diagonal, the tail clipped at ±64K
    scale = 25000.0
    off = np.clip(rs.laplace(0.0, scale, m), -65536, 65535).astype(np.int64)
    cols = np.clip(rows + off, 0, n - 1)
    vals = rs.uniform(0.1, 1.0, m)
    return rows, cols, vals


def rmat(scale, nnz, seed, dtype, a=0.57, b=0.19, c=0.19):
    """Kronecker/R-MAT stand-in (kron_g500 class): power-law both ways,
    globally scattered columns."""
    rs = np.random.RandomState(seed)
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for level in range(scale):
        r = rs.random(nnz)
        row_bit = r >= a + b                      # quadrants c, d
        col_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)   # b, d
        rows |= row_bit.astype(np.int64) << level
        cols |= col_bit.astype(np.int64) << level
    vals = rs.uniform(-1.0, 1.0, nnz).astype(dtype)
    return rows, cols, vals


def banded(n, deg, sigma, seed, dtype):
    """FEM-band stand-in: deg nnz/row, normal column offsets (bandwidth
    ~6 sigma) — the cant/pdb1HYS/cage15 locality class."""
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    off = rs.normal(0.0, sigma, rows.size).astype(np.int64)
    cols = np.clip(rows + off, 0, n - 1)
    vals = rs.uniform(-1.0, 1.0, rows.size).astype(dtype)
    return rows, cols, vals


def powerlaw_web(n, nnz, local_frac, spread, seed, dtype, alpha=1.2):
    """Web-graph stand-in: heavy-tail row degrees (pareto ``alpha``) and
    heavy-tail global-link targets.  Columns are a local/global mix; the
    global share samples a Zipf-ranked random permutation of the pages,
    so that hub columns land anywhere in the column space."""
    rs = np.random.RandomState(seed)
    raw = rs.pareto(alpha, n) + 1.0
    deg = np.maximum(1, (raw * (nnz / raw.sum())).astype(np.int64))
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    m = rows.size
    local = rs.random(m) < local_frac
    perm = rs.permutation(n).astype(np.int64)
    rank = np.minimum((rs.pareto(0.7, m) * 1.5).astype(np.int64), n - 1)
    cols = np.where(
        local,
        np.clip(rows + rs.randint(-spread, spread + 1, m), 0, n - 1),
        perm[rank])
    vals = rs.uniform(-1.0, 1.0, m).astype(dtype)
    return rows, cols, vals


def skew_trio(n, deg, seed=0):
    """Yields ("uniform" | "powerlaw" | "wheel", float32 CsrMatrix): equal
    nnz (n * deg) with uniform row degrees and columns within ±2048 of
    the row, with pareto(1.6) degrees and the same column model, and the
    wheel of min(nnz / 2, 2,000,000) spokes.  Each matrix's values are
    uniform(0.5, 1.5), drawn from the one RandomState right after its
    structure, as the JAX tool's ``bench_one`` draws them; a generator, so
    that a caller holds one matrix at a time."""
    rs = np.random.RandomState(seed)
    nnz = n * deg

    def with_values(coo):
        csr = CsrMatrix.from_coo(coo).astype(np.float32)
        csr.values = rs.uniform(0.5, 1.5, csr.num_nonzeros
                                ).astype(np.float32)
        return csr

    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols_u = np.clip(rows + rs.randint(-2048, 2048, rows.size), 0, n - 1)
    yield "uniform", with_values(CooMatrix(n, n, rows, cols_u,
                                           np.ones(rows.size)))
    del rows, cols_u
    raw = rs.pareto(1.6, n) + 1.0
    degs = np.maximum(1, (raw * (nnz / raw.sum())).astype(np.int64))
    rows_p = np.repeat(np.arange(n, dtype=np.int64), degs)
    cols_p = np.clip(rows_p + rs.randint(-2048, 2048, rows_p.size),
                     0, n - 1)
    yield "powerlaw", with_values(CooMatrix(n, n, rows_p, cols_p,
                                            np.ones(rows_p.size)))
    del rows_p, cols_p
    yield "wheel", with_values(CooMatrix.wheel(min(nnz // 2, 2_000_000)))


def _weak_draw(rs, n, deg):
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rs.randint(-2000, 2001, rows.size), 0, n - 1)
    vals = rs.uniform(0.1, 1.0, rows.size)
    x = rs.uniform(0.1, 1.0, n).astype(np.float32)
    return CooMatrix(n, n, rows, cols, vals), x


def weak_scaling_matrices(rows_per_shard, deg=8, shards=WEAK_SHARDS,
                          seed=0):
    """({S: (csr, x)} for S in ``shards``, (csr_f, x_f)): the weak-scaling
    matrix of S * rows_per_shard rows, deg nonzeros a row within ±2000 of
    the diagonal, values uniform(0.1, 1), and the fixed-total-work matrix
    of the largest S's size, all float32.  Every S of WEAK_SHARDS is drawn
    from the one RandomState in order, then the fixed matrix, as the JAX
    tool draws them on its 8-device mesh; only the S asked for are built."""
    rs = np.random.RandomState(seed)
    weak = {}
    for s in WEAK_SHARDS:
        coo, x = _weak_draw(rs, rows_per_shard * s, deg)
        if s in shards:
            weak[s] = (CsrMatrix.from_coo(coo).astype(np.float32), x)
    coo, x_f = _weak_draw(rs, rows_per_shard * WEAK_SHARDS[-1], deg)
    return weak, (CsrMatrix.from_coo(coo).astype(np.float32), x_f)
