"""SpMM in one launch (K1m, K3m) held against the JAX package on the CPU.

``SpmvOperator.mm`` runs the multi-RHS merge kernel's plain version
(``merge_csrmm_plain``: the same tiles, runs and k-wide carries) for a
matrix on the CPU; ``DiaSpmvOperator.mm`` the multi-RHS DIA kernel's
(``dia_matmat_plain``) and its leftover's ``mm``.  The same inputs, made
from a seed with numpy, go through the JAX package:

* ``csrmm_xla`` and the JAX ``SpmvOperator.mm`` (xla backend) for the
  merge operator, on a uniform, a power-law, the wheel (one row across
  many tiles: 256-item tiles, a run per tile, so runs end mid-row), an
  empty-rows and an nnz = 0 matrix, k in {2, 3, 8, 32, 40}, with and
  without Y_in, alpha = 1.5, beta = -0.5;
* the JAX ``DiaSpmvOperator.mm`` with and without a leftover;
* the split and hot/cold ``mm`` at k = 3.

Tolerances: float32 by ``compare_results(..., abs_bound=spmv_abs_bound)``
per column; float64 within 2 gamma_n |alpha| |A| |X| + |beta Y_in| per row
(bench/measure.py::fp64_check, n the row's length) against ``csrmm_xla``
run under ``jax.enable_x64``, since two float64 sums of n products in any
order lie that close.  Also the plain version against the column loop,
the methods, and K1m's lane layout and launch geometry (ops/plan.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
import merge_spmv_tpu.ops.csrmv_xla as jx
import merge_spmv_tpu.ops.split as J
from merge_spmv_tpu.ops.dia import build_dia_operator as jbuild_dia
from merge_spmv_tpu.ops.operator import build_operator as jbuild_operator
from merge_spmv_tpu_torch.bench.measure import fp64_check
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops import dia_cuda as D
from merge_spmv_tpu_torch.ops import plan as P
from merge_spmv_tpu_torch.ops import split as S
from merge_spmv_tpu_torch.ops.csrmv import csrmm
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils.compare import compare_results

ALPHA, BETA = 1.5, -0.5
TILE = 256
MATRICES = {
    "uniform": lambda: jcoo.CooMatrix.random_uniform(900, 700, 7, seed=2),
    "powerlaw": lambda: jcoo.CooMatrix.random_powerlaw(800, 700, 6000,
                                                       seed=3),
    "wheel": lambda: jcoo.CooMatrix.wheel(3000),
    "empty_rows": lambda: jcoo.CooMatrix(900, 64, rows=[5, 5, 850],
                                         cols=[0, 63, 3], vals=[1., 2., 3.]),
    "nnz0": lambda: jcoo.CooMatrix(700, 9, rows=[], cols=[], vals=[]),
}
KS = (2, 3, 8, 32, 40)


def _pair(make, dtype, seed=0):
    """A JAX-package CSR and its port twin on the same signed values."""
    j = jcsr.CsrMatrix.from_coo(make()).astype(dtype)
    j.values = np.random.RandomState(seed).uniform(
        -1, 1, j.num_nonzeros).astype(dtype)
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    return j, t


def _operands(j, k, dtype, with_y, seed=1):
    rs = np.random.RandomState(seed)
    X = rs.uniform(-1, 1, (j.num_cols, k)).astype(dtype)
    Y_in = rs.uniform(-1, 1, (j.num_rows, k)).astype(dtype)
    return X, (Y_in if with_y else None)


def _check(got, want, j, X, Y_in, alpha, beta, what):
    """Each column of ``got`` against ``want``: compare_results within
    spmv_abs_bound in float32, the float64 rounding bound in float64."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (j.num_rows, X.shape[1]), what
    lengths = np.diff(j.row_offsets)
    for c in range(X.shape[1]):
        yc = None if Y_in is None else Y_in[:, c]
        b = 0.0 if Y_in is None else beta
        if got.dtype == np.float64:
            scale = j.spmv_abs_bound(X[:, c], yc, alpha, b,
                                     segmented_block=0)
            ok, worst = fp64_check(got[:, c], want[:, c], lengths, scale)
            assert ok, f"{what}[:, {c}]: {worst} of the float64 bound"
        else:
            bound = j.spmv_abs_bound(X[:, c], yc, alpha, b)
            assert compare_results(got[:, c], want[:, c], verbose=False,
                                   abs_bound=bound) is None, f"{what}[:, {c}]"


def _csrmm_xla(j, X, Y_in, alpha, beta, dtype):
    with jax.enable_x64(dtype == np.float64):
        v, re_, ci = j.to_device(dtype=dtype)
        return np.asarray(jx.csrmm_xla(
            v, re_, ci, jnp.asarray(X),
            Y_in=None if Y_in is None else jnp.asarray(Y_in), alpha=alpha,
            beta=beta))


def _t(a):
    return None if a is None else torch.from_numpy(a)


# ---------------------------------------------------------------------- #
# SpmvOperator.mm (merge_csrmm_plain) against the JAX package
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_operator_mm_vs_jax(name, k, with_y, dtype):
    j, t = _pair(MATRICES[name], dtype)
    X, Y_in = _operands(j, k, dtype, with_y)
    dname = np.dtype(dtype).name
    op = build_operator(t, dtype=dname, device="cpu", tile_items=TILE)
    got = op.mm(_t(X), Y_in=_t(Y_in), alpha=ALPHA, beta=BETA)
    assert got.dtype == torch.from_numpy(X).dtype
    got = got.numpy()
    _check(got, _csrmm_xla(j, X, Y_in, ALPHA, BETA, dtype), j, X, Y_in,
           ALPHA, BETA, "csrmm_xla")
    gold = np.stack([j.spmv_gold(X[:, c], None if Y_in is None
                                 else Y_in[:, c], ALPHA,
                                 0.0 if Y_in is None else BETA)
                     for c in range(k)], 1)
    _check(got, gold, j, X, Y_in, ALPHA, BETA, "gold")
    if dtype == np.float32:
        jop = jbuild_operator(j, dtype="float32", backend="xla")
        want = jop.mm(jnp.asarray(X),
                      None if Y_in is None else jnp.asarray(Y_in), ALPHA,
                      BETA)
        _check(got, want, j, X, Y_in, ALPHA, BETA, "jax SpmvOperator.mm")


def test_wheel_runs_end_mid_row():
    """The wheel's hub row spans many 256-item tiles and, at the plain
    version's geometry (a run per tile here), many runs: its carries are
    what the fix-up joins."""
    _, t = _pair(MATRICES["wheel"], np.float32)
    op = build_operator(t, device="cpu", tile_items=TILE)
    geo = K.mm_launch_geometry(op.plan.num_tiles, TILE, torch.float32,
                               torch.device("cpu"), 8)
    ends = op.tile_rows[geo.run_tiles::geo.run_tiles].long()
    hub_len = int(np.diff(t.row_offsets).max())
    assert hub_len > 4 * TILE
    assert int((ends == int(np.argmax(np.diff(t.row_offsets)))).sum()) > 3


@pytest.mark.parametrize("run_tiles", [1, 3, None])
@pytest.mark.parametrize("k", [2, 8, 40])
@pytest.mark.parametrize("name", ["wheel", "powerlaw", "empty_rows"])
def test_merge_csrmm_plain_vs_column_loop(name, k, run_tiles):
    """K1m's plain version against the column loop's (merge_csrmv_plain
    once per column) at the same runs, and the CPU wrapper is the plain
    version and counts no launch."""
    j, t = _pair(MATRICES[name], np.float32)
    X, Y_in = _operands(j, k, np.float32, True)
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    tiles = merge_tile_coordinates(re_, t.num_nonzeros, TILE)
    run = 2 if run_tiles is None else run_tiles
    got = K.merge_csrmm_plain(v, ci, re_, _t(X), *tiles, TILE, _t(Y_in),
                              ALPHA, BETA, run_tiles=run)
    loop = torch.stack([K.merge_csrmv_plain(
        v, ci, re_, _t(X[:, c].copy()), *tiles, TILE, _t(Y_in[:, c].copy()),
        ALPHA, BETA, run_tiles=run) for c in range(k)], 1)
    _check(got.numpy(), loop.numpy(), j, X, Y_in, ALPHA, BETA, "loop")
    K.reset_launches()
    wrapped = K.merge_csrmm(v, ci, re_, _t(X), *tiles, TILE, _t(Y_in),
                            ALPHA, BETA, run_tiles=run_tiles)
    assert not any(K.LAUNCHES.values()) and K.COPIES["x_row_major"] == 0
    if run_tiles is not None:
        assert torch.equal(wrapped, got)


def test_functional_csrmm_routes():
    """csrmm on a "cuda"-backend plan goes through merge_csrmm (the plain
    version for CPU tensors); the "torch" backend through csrmm_torch."""
    j, t = _pair(MATRICES["powerlaw"], np.float32)
    X, _ = _operands(j, 5, np.float32, False)
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    plan = P.make_plan(t.num_rows, t.num_cols, t.num_nonzeros,
                       device="cpu", tile_items=TILE)
    import dataclasses
    merge_plan = dataclasses.replace(plan, backend="cuda")
    want = _csrmm_xla(j, X, None, 1.0, 0.0, np.float32)
    for p in (plan, merge_plan):
        _check(csrmm(p, v, re_, ci, _t(X)).numpy(), want, j, X, None, 1.0,
               0.0, p.backend)


def test_k1_and_k0_columns():
    """k = 1 is op(x); k = 0 gives an empty [m, 0]."""
    j, t = _pair(MATRICES["uniform"], np.float32)
    op = build_operator(t, device="cpu", tile_items=TILE)
    X, _ = _operands(j, 1, np.float32, False)
    assert torch.equal(op.mm(_t(X))[:, 0], op(_t(X[:, 0].copy())))
    assert op.mm(torch.zeros(t.num_cols, 0)).shape == (t.num_rows, 0)


def test_bfloat16_operator_mm_rounds_x_as_op_x():
    j, t = _pair(MATRICES["powerlaw"], np.float32)
    op = build_operator(t, dtype="bfloat16", device="cpu", tile_items=TILE)
    X, _ = _operands(j, 4, np.float32, False)
    Xb = _t(X).to(torch.bfloat16)
    Y = op.mm(Xb)
    assert Y.dtype == torch.bfloat16
    for c in range(4):
        assert torch.equal(Y[:, c], op(Xb[:, c].contiguous()))


@pytest.mark.parametrize("kind", ["merge", "dia"])
def test_methods(kind):
    """"column" is the column loop, "auto" agrees with it, "wide" and
    unknown names raise."""
    if kind == "merge":
        j, t = _pair(MATRICES["powerlaw"], np.float32)
        op = build_operator(t, device="cpu", tile_items=TILE)
    else:
        j, t = _pair(lambda: jcoo.CooMatrix.grid3d(8), np.float32)
        op = build_dia_operator(t, device="cpu")
    X, Y_in = _operands(j, 3, np.float32, True)
    col = op.mm(_t(X), _t(Y_in), ALPHA, BETA, method="column")
    loop = torch.stack([op(_t(X[:, c].copy()), _t(Y_in[:, c].copy()),
                           ALPHA, BETA) for c in range(3)], 1)
    assert torch.equal(col, loop)
    _check(op.mm(_t(X), _t(Y_in), ALPHA, BETA).numpy(), col.numpy(), j, X,
           Y_in, ALPHA, BETA, "auto vs column")
    with pytest.raises(ValueError, match="wide"):
        op.mm(_t(X), method="wide")
    with pytest.raises(ValueError, match="unknown method"):
        op.mm(_t(X), method="rows")


# ---------------------------------------------------------------------- #
# DiaSpmvOperator.mm (dia_matmat_plain) against the JAX package
# ---------------------------------------------------------------------- #

def _mixed():
    base = jcoo.CooMatrix.grid2d(40)
    rs = np.random.RandomState(2)
    return jcoo.CooMatrix(1600, 1600, np.r_[base.rows, rs.randint(0, 1600,
                                                                  300)],
                          np.r_[base.cols, rs.randint(0, 1600, 300)],
                          np.r_[base.vals, rs.uniform(-1, 1, 300)])


def _rectangular():
    m = 300
    return jcoo.CooMatrix(m, 400, np.r_[np.arange(m), np.arange(m)],
                          np.r_[np.arange(m), np.arange(m) + 50],
                          np.ones(2 * m))


DIA = {"grid3d10": (lambda: jcoo.CooMatrix.grid3d(10), False),
       "rectangular": (_rectangular, False),
       "mixed": (_mixed, True)}


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("k", [2, 3, 32])
@pytest.mark.parametrize("name", sorted(DIA))
def test_dia_mm_vs_jax(name, k, with_y):
    make, leftover = DIA[name]
    j, t = _pair(make, np.float32, seed=3)
    jop = jbuild_dia(j, dtype="float32")
    op = build_dia_operator(t, dtype="float32", device="cpu")
    assert (op.rest_op is not None) == leftover == (jop.rest_op is not None)
    X, Y_in = _operands(j, k, np.float32, with_y)
    got = op.mm(_t(X), Y_in=_t(Y_in), alpha=ALPHA, beta=BETA).numpy()
    want = jop.mm(jnp.asarray(X),
                  Y_in=None if Y_in is None else jnp.asarray(Y_in),
                  alpha=ALPHA, beta=BETA)
    _check(got, want, j, X, Y_in, ALPHA, BETA, "jax DiaSpmvOperator.mm")


@pytest.mark.parametrize("k", [1, 4, 9])
def test_dia_matmat_plain_is_the_column_product(k):
    """dia_matmat on CPU tensors is its plain version, counts no launch,
    and is dia_matvec_plain column by column plus beta * Y_in."""
    j, t = _pair(lambda: jcoo.CooMatrix.grid3d(7), np.float32, seed=4)
    op = build_dia_operator(t, device="cpu")
    X, Y_in = _operands(j, k, np.float32, True)
    D.reset_launches()
    got = D.dia_matmat(op.vtab, _t(X), op.offsets_t, op.num_rows,
                       op.num_cols, 2.0, _t(Y_in), 0.25)
    assert not any(D.LAUNCHES.values())
    want = torch.stack([D.dia_matvec_plain(
        op.vtab, _t(X[:, c].copy()), op.offsets_t, op.num_rows,
        op.num_cols, 2.0) for c in range(k)], 1) + 0.25 * _t(Y_in)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------- #
# The split and hot/cold operators' mm
# ---------------------------------------------------------------------- #

def _scattered(n=1500, deg=5, spread=400, seed=3):
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rs.laplace(0.0, spread, rows.size).astype(
        np.int64), 0, n - 1)
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(
        n, n, rows, cols, rs.uniform(-1, 1, rows.size))).astype(np.float32)


def _hubs(n=12000, deg=6, hubs=20, seed=7):
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    hub_cols = rs.choice(n, hubs, replace=False)
    cols = np.where(rs.random(rows.size) < 0.6,
                    hub_cols[rs.randint(0, hubs, rows.size)],
                    rs.randint(0, n, rows.size))
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(
        n, n, rows, cols, rs.uniform(-1, 1, rows.size))).astype(np.float32)


@pytest.mark.parametrize("kind", ["split", "compact", "hotcold"])
def test_split_and_hotcold_mm_vs_jax(kind):
    j = _hubs() if kind == "hotcold" else _scattered()
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    if kind == "hotcold":
        op = S.build_hotcold_operator(t, device="cpu")
        jop = J.build_hotcold_operator(j)
        assert op.hot_op is not None
    else:
        kw = dict(edges_chunks="quantile", num_bands=4,
                  compact_rows=kind == "compact", tile_items=2048)
        op = S.SplitSpmvOperator(t, device="cpu", **kw)
        jop = J.SplitSpmvOperator(j, **kw)
    X, Y_in = _operands(j, 3, np.float32, True)
    got = op.mm(_t(X), Y_in=_t(Y_in), alpha=ALPHA, beta=BETA).numpy()
    want = jop.mm(jnp.asarray(X), Y_in=jnp.asarray(Y_in), alpha=ALPHA,
                  beta=BETA, interpret=True)
    _check(got, want, j, X, Y_in, ALPHA, BETA, f"jax {kind} mm")


# ---------------------------------------------------------------------- #
# K1m's lane layout and launch geometry (ops/plan.py)
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,align", [("float32", 16), ("float32", 8),
                                         ("float32", 4), ("float64", 16),
                                         ("float64", 8)])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 31, 32, 33, 40, 64])
def test_mm_layout_holds_k_columns(k, dtype, align):
    """align: the operands' common alignment, at least the value size."""
    size = 8 if dtype == "float64" else 4
    lay = P.mm_layout(k, dtype, align)
    assert k <= lay.width <= P.MM_MAX_K
    assert lay.lanes in (1, 2, 4, 8, 16, 32)
    if lay.vector:
        assert k % lay.per == 0 and lay.per * size in (4, 8, 16)
        assert lay.per * size <= align
        assert lay.lanes == 1 << (-(-k // lay.per) - 1).bit_length()
    else:
        assert (lay.per, lay.lanes) == (2, 32) and k > 32
    if k % 4 == 0 and dtype == "float32" and align == 16:
        assert (lay.per, lay.vector) == (4, True)
    with pytest.raises(ValueError):
        P.mm_layout(P.MM_MAX_K + 1, dtype, align)


@pytest.mark.parametrize("tile_items", [256, 1024, 2048, 4096])
def test_mm_geometry(tile_items):
    """Chunks of about MM_CHUNK_ITEMS merge items, at most
    MM_BLOCKS_PER_SM blocks an SM, one wave, k-wide carries, and the
    shared memory of csrc/merge_csrmm.cu's layout: two mbarriers, two
    stages with the bulk copies' slack, the warps' scan totals, flags and
    starts."""
    g = P.mm_geometry(3966, tile_items, "float32", 32)
    assert g.chunk_items == max(tile_items, P.MM_CHUNK_ITEMS)
    assert g.chunk_tiles * tile_items == g.chunk_items
    assert g.blocks_per_sm == min(
        P.MM_BLOCKS_PER_SM,
        _granted(g.carveout) // (g.shared_bytes + P.BLOCK_RESERVED_SHARED))
    assert g.grid <= P.MM_BLOCKS_PER_SM * P.H100_SMS
    assert (g.grid - 1) * g.run_tiles < 3966 <= g.grid * g.run_tiles
    assert g.carry_bytes == g.grid * (4 + 32 * 4)
    warps = P.MM_THREADS // 32
    assert g.shared_bytes == (16 + 2 * (g.chunk_items * (4 + 4)
                                        + P.MM_STAGE_SLACK)
                              + warps * 32 * 4 + 2 * warps * 4)
    assert g.batch_rows == 3   # 16-byte lanes, 8 a walker
    g64 = P.mm_geometry(3966, tile_items, "float64", 64)
    assert g64.shared_bytes == (16 + 2 * (g64.chunk_items * (8 + 4)
                                          + P.MM_STAGE_SLACK)
                                + warps * 64 * 8 + 2 * warps * 4)
    assert g64.shared_bytes <= P.BLOCK_SHARED_MAX
    one = P.mm_geometry(1, tile_items, "float32", 3, blocks_per_sm=1)
    assert (one.grid, one.run_tiles, one.blocks_per_sm) == (1, 1, 1)


def _granted(carveout: int) -> int:
    """The shared memory an SM gives for a carveout preference (percent):
    the smallest carveout the card offers that holds it."""
    return next(kb * 1024 for kb in P.SM_CARVEOUTS_KB
                if kb * 1024 * 100 >= carveout * P.SM_SHARED_BYTES)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", range(1, P.MM_MAX_K + 1))
def test_mm_geometry_fits_every_k(k, dtype):
    """For every k a launch takes, every alignment and every tile size:
    the block's shared memory is csrc/merge_csrmm.cu's layout for its lane
    layout, fits a block's 227 KB, and the blocks an SM runs fit the
    carveout the instantiation asks for (at least one block)."""
    size = 8 if dtype == "float64" else 4
    for align in (a for a in (16, 8, 4) if a >= size):
        lay = P.mm_layout(k, dtype, align)
        rows = P.mm_batch_rows(dtype, lay)
        assert rows in (2, 3, 4)
        for tile_items in range(P.MIN_TILE_ITEMS, P.MAX_TILE_ITEMS + 1,
                                P.MIN_TILE_ITEMS):
            g = P.mm_geometry(3966, tile_items, dtype, k, align)
            assert g.layout == lay and g.batch_rows == rows
            assert g.shared_bytes == P.mm_shared_bytes(g.chunk_items, dtype,
                                                       lay)
            assert g.shared_bytes <= P.BLOCK_SHARED_MAX
            assert g.carveout == P.mm_carveout(dtype, lay) <= 100
            assert 1 <= g.blocks_per_sm <= P.MM_BLOCKS_PER_SM
            assert g.blocks_per_sm * (g.shared_bytes
                                      + P.BLOCK_RESERVED_SHARED) \
                <= _granted(g.carveout)
