"""The port's split operators held against the JAX package's on the same
inputs (tests/test_split.py's fixtures and cases).

* The host helpers (band_assignment, stack_bands, stack_bands_compact,
  split_by_distance, popularity_assignment) must give bit-equal arrays.
* The operators on ``device="cpu"`` (the merge kernel's plain version under
  the stack, torch epilogues) must pass ``compare_results(...,
  abs_bound=spmv_abs_bound)`` against gold AND against the JAX operator's
  output, got as tests/test_split.py gets it (``interpret=True`` on the
  JAX CPU backend).  SpMM is held at tests/test_split.py's 1e-5 of the
  largest |gold|.
* The device builder on the CPU must give the JAX device builder's edges,
  band count, band nnz, m_pad and stacked arrays; the stacked split of
  either package uses the same explicit ``tile_items``.
* A split operator built by ``from_stacked`` over the JAX operator's
  stacked arrays computes the JAX result (state carried across).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
import merge_spmv_tpu.ops.split as J
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import split as S
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.plan import make_plan
from merge_spmv_tpu_torch.utils.compare import compare_results

# one tile size for both packages wherever stacked arrays are compared
TILE = 2048


def _scattered(n=4000, deg=9, spread=1500, seed=3):
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    off = rs.laplace(0.0, spread, rows.size).astype(np.int64)
    cols = np.clip(rows + off, 0, n - 1)
    vals = rs.uniform(-1.0, 1.0, rows.size)
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(n, n, rows, cols, vals)
                                   ).astype(np.float32)


def _powerlaw_cols(n=20000, deg=8, hubs=40, hub_frac=0.6, seed=7):
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    m = rows.size
    hub_cols = rs.choice(n, hubs, replace=False)
    is_hub = rs.random(m) < hub_frac
    cols = np.where(is_hub, hub_cols[rs.randint(0, hubs, m)],
                    rs.randint(0, n, m))
    vals = rs.uniform(-1.0, 1.0, m)
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(n, n, rows, cols, vals)
                                   ).astype(np.float32)


def _flat(n=20000, deg=9, seed=5):
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = rs.randint(0, n, rows.size)
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(
        n, n, rows, cols, rs.uniform(-1, 1, rows.size))).astype(np.float32)


def _all_hot(n=1500, deg=5, seed=3):
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    hub = rs.choice(512, 64, replace=False)
    cols = hub[rs.randint(0, 64, rows.size)]
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(
        n, n, rows, cols, rs.uniform(-1, 1, rows.size))).astype(np.float32)


def _compact_fixture():
    rs = np.random.RandomState(7)
    n, nnz = 8000, 64000
    r_ = rs.randint(0, n, nnz)
    c_ = np.clip(r_ + rs.laplace(0, 500, nnz).astype(np.int64), 0, n - 1)
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(
        n, n, r_, c_, rs.uniform(-1, 1, nnz).astype(np.float32)))


def _port(j):
    """The port's CsrMatrix over the JAX CSR's arrays."""
    return CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                                 j.col_indices, j.values)


def _vecs(csr, seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, csr.num_cols).astype(np.float32),
            rs.uniform(-1, 1, csr.num_rows).astype(np.float32))


def _check(got, jax_out, csr, x, y0=None, alpha=1.0, beta=0.0):
    """The port's result against gold and against the JAX operator's."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    bound = csr.spmv_abs_bound(x, y0, alpha=alpha, beta=beta)
    gold = csr.spmv_gold(x, y0, alpha=alpha, beta=beta)
    assert got.shape == gold.shape and got.dtype == np.float32
    assert compare_results(got, gold, abs_bound=bound) is None
    assert compare_results(got, np.asarray(jax_out), abs_bound=bound) is None


def _check_mm(got, jax_out, csr, X):
    got = got.numpy()
    gold = csr.spmm_gold(X)
    scale = np.max(np.abs(gold)) + 1e-9
    assert got.shape == gold.shape
    assert np.max(np.abs(got - gold)) / scale < 1e-5
    assert np.max(np.abs(got - np.asarray(jax_out))) / scale < 1e-5


def _same_csr(a, b):
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
    for name in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


# ---------------------------------------------------------------- helpers

@pytest.mark.parametrize("fixture,kw", [
    (_scattered, {"edges_chunks": (1, 2)}),
    (_scattered, {"edges_chunks": (8, 32)}),
    (_scattered, {"edges_chunks": "quantile", "num_bands": 4}),
    (lambda: _scattered(n=2000, spread=100),
     {"edges_chunks": (1, 2), "min_frac": 0.05}),
    (_compact_fixture, {"edges_chunks": "quantile", "num_bands": 6}),
    (_scattered, {"edges_chunks": "quantile", "num_bands": 1}),
])
def test_band_assignment_matches_jax(fixture, kw):
    j = fixture()
    band, nb = S.band_assignment(_port(j), **kw)
    jband, jnb = J.band_assignment(j, **kw)
    assert nb == jnb
    assert band.dtype == jband.dtype == np.int8
    np.testing.assert_array_equal(band, jband)


def test_split_is_partition():
    j = _scattered()
    csr = _port(j)
    bands, band_ids = S.split_by_distance(csr, edges_chunks=(1, 2))
    jbands, jband_ids = J.split_by_distance(j, edges_chunks=(1, 2))
    np.testing.assert_array_equal(band_ids, jband_ids)
    assert len(bands) == len(jbands)
    for b, jb in zip(bands, jbands):
        _same_csr(b, jb)
    assert sum(b.num_nonzeros for b in bands) == csr.num_nonzeros
    for b in bands:
        assert b.num_rows == csr.num_rows and b.num_cols == csr.num_cols
        assert b.row_offsets[-1] == b.num_nonzeros
    x = np.ones(csr.num_cols)
    total = sum(b.astype(np.float64).spmv_gold(x) for b in bands)
    assert np.allclose(total, csr.astype(np.float64).spmv_gold(x),
                       rtol=1e-6)


def test_split_small_bands_merged():
    j = _scattered(n=2000, spread=100)
    bands, ids = S.split_by_distance(_port(j), edges_chunks=(1, 2),
                                     min_frac=0.05)
    assert len(bands) <= 3
    np.testing.assert_array_equal(
        ids, J.split_by_distance(j, edges_chunks=(1, 2), min_frac=0.05)[1])


@pytest.mark.parametrize("tile_items", [0, 1024, TILE, 4096])
@pytest.mark.parametrize("fixture", [_scattered, _compact_fixture])
def test_stack_bands_matches_jax(fixture, tile_items):
    j = fixture()
    csr = _port(j)
    band, nb = S.band_assignment(csr, "quantile", num_bands=5)
    stacked, m_pad = S.stack_bands(csr, band, nb, tile_items=tile_items)
    jstacked, jm_pad = J.stack_bands(j, band, nb, tile_items=tile_items)
    assert m_pad == jm_pad
    _same_csr(stacked, jstacked)
    if tile_items:
        # every band starts on a merge-tile boundary
        for b in range(1, nb):
            start = int(stacked.row_offsets[b * m_pad])
            assert start % 1024 == 0 and (b * m_pad + start) % tile_items == 0


@pytest.mark.parametrize("tile_items", [1024, TILE])
@pytest.mark.parametrize("fixture", [_scattered, _compact_fixture])
def test_stack_bands_compact_matches_jax(fixture, tile_items):
    j = fixture()
    csr = _port(j)
    band, nb = S.band_assignment(csr, "quantile", num_bands=6)
    got = S.stack_bands_compact(csr, band, nb, tile_items=tile_items)
    want = J.stack_bands_compact(j, band, nb, tile_items=tile_items)
    _same_csr(got[0], want[0])
    for a, b in zip(got[1:3], want[1:3]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


def test_stack_tile_items_checked():
    csr = _port(_scattered(n=1000))
    band, nb = S.band_assignment(csr, "quantile", num_bands=3)
    assert nb > 1
    for bad in (1536, 8192):
        with pytest.raises(ValueError, match="multiple of 1024"):
            S.stack_bands(csr, band, nb, tile_items=bad)
        with pytest.raises(ValueError, match="multiple of 1024"):
            S.stack_bands_compact(csr, band, nb, tile_items=bad)
    with pytest.raises(ValueError, match="needs tile_items"):
        S.stack_bands_compact(csr, band, nb)


@pytest.mark.parametrize("rows,nnz,want", [
    (40_000, 20_000, 2048),      # the plan's default 2048
    (100, 50, 1024),             # halved to 512 on a small list: 1024
    (300, 0, 1024),              # halved to 1024
])
def test_split_tile_items_rounds_the_plan_up(rows, nnz, want):
    assert make_plan(rows, 1, nnz, device="cpu").tile_items <= want
    assert S.split_tile_items(rows, nnz) == want


@pytest.mark.parametrize("fixture,kw", [
    (_powerlaw_cols, {"coverage": 0.5}),
    (_flat, {"coverage": 0.5}),
    (_all_hot, {"coverage": 1.0, "min_gain": 0.0}),
    (_scattered, {}),
])
def test_popularity_assignment_matches_jax(fixture, kw):
    j = fixture()
    mask, windows = S.popularity_assignment(_port(j), **kw)
    jmask, jwindows = J.popularity_assignment(j, **kw)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(windows, jwindows)


def test_popularity_assignment_selects_hubs():
    csr = _port(_powerlaw_cols())
    hot_mask, hot_windows = S.popularity_assignment(csr, coverage=0.5)
    assert hot_windows.size > 0
    assert hot_mask.sum() >= 0.3 * csr.num_nonzeros
    assert hot_windows.size * 128 < csr.num_cols
    assert (np.diff(hot_windows) > 0).all()


def test_popularity_assignment_flat_profile_selects_nothing():
    hot_mask, hot_windows = S.popularity_assignment(_port(_flat()),
                                                    coverage=0.5)
    assert hot_windows.size == 0
    assert not hot_mask.any()


# ---------------------------------------------------------------- operators

def test_split_operator_matches_gold():
    j = _scattered()
    csr = _port(j)
    op = S.build_split_operator(csr, edges_chunks=(1, 2), tile_items=TILE,
                                device="cpu")
    jop = J.build_split_operator(j, edges_chunks=(1, 2), tile_items=TILE)
    assert op.num_bands >= 2 and op.num_bands == jop.num_bands
    assert op.band_nnz == jop.band_nnz
    _same_csr(op.stacked, jop.stacked)
    x, y0 = _vecs(csr, 0)
    y = op(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=1.5,
           beta=-0.5)
    jy = jop(jnp.asarray(x), y_in=jnp.asarray(y0), alpha=1.5, beta=-0.5,
             interpret=True)
    _check(y, jy, csr, x, y0, 1.5, -0.5)


def test_split_quantile_operator_matches_gold():
    j = _scattered(n=3000, deg=7, spread=900)
    csr = _port(j)
    op = S.build_split_operator(csr, edges_chunks="quantile", num_bands=4,
                                tile_items=TILE, device="cpu")
    jop = J.build_split_operator(j, edges_chunks="quantile", num_bands=4,
                                 tile_items=TILE)
    assert op.num_bands >= 2
    # the plan is the stack's (B * m_pad rows); shape is the matrix's
    assert op.plan.num_rows == op.num_bands * op._m_pad
    assert op.stacked.num_rows == op.num_bands * op._m_pad
    assert op._m_pad >= csr.num_rows
    assert op.shape == (csr.num_rows, csr.num_cols)
    assert np.count_nonzero(op.stacked.values) == np.count_nonzero(
        csr.values)
    assert sum(op.band_nnz) == csr.num_nonzeros
    _same_csr(op.stacked, jop.stacked)
    # the original matrix's row norm, not the stack's partial rows
    want = np.bincount(csr.row_ids(), weights=np.abs(
        csr.values.astype(np.float64)), minlength=csr.num_rows).max()
    assert op.abs_row_sum_max == pytest.approx(want, rel=1e-12)
    x, y0 = _vecs(csr, 2)
    y = op(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=2.0,
           beta=0.25)
    jy = jop(jnp.asarray(x), y_in=jnp.asarray(y0), alpha=2.0, beta=0.25,
             interpret=True)
    _check(y, jy, csr, x, y0, 2.0, 0.25)


def test_split_operator_mm_matches_gold():
    j = _scattered(n=1500, deg=5, spread=400)
    csr = _port(j)
    op = S.build_split_operator(csr, edges_chunks=(1,), tile_items=TILE,
                                device="cpu")
    jop = J.build_split_operator(j, edges_chunks=(1,), tile_items=TILE)
    X = np.random.RandomState(1).uniform(-1, 1, (csr.num_cols, 3)).astype(
        np.float32)
    _check_mm(op.mm(torch.from_numpy(X)),
              jop.mm(jnp.asarray(X), interpret=True), csr, X)


def test_compact_row_split_matches_gold():
    j = _compact_fixture()
    csr = _port(j)
    n = csr.num_rows
    rs = np.random.RandomState(7)
    x = rs.uniform(0.5, 1.5, n).astype(np.float32)
    y0 = rs.uniform(-1, 1, n).astype(np.float32)
    sop = S.SplitSpmvOperator(csr, edges_chunks="quantile", num_bands=6,
                              compact_rows=True, tile_items=TILE,
                              device="cpu")
    jsop = J.SplitSpmvOperator(j, edges_chunks="quantile", num_bands=6,
                               compact_rows=True, tile_items=TILE)
    assert sop._gather_idx is not None
    assert sop.op.plan.num_rows < 6 * (-(-n // 1024) * 1024)
    _same_csr(sop.stacked, jsop.stacked)
    np.testing.assert_array_equal(sop._gather_idx.numpy(),
                                  np.asarray(jsop._gather_idx))
    np.testing.assert_array_equal(sop._seg_ends.numpy(),
                                  np.asarray(jsop._seg_ends))
    _check(sop(torch.from_numpy(x)), jsop(jnp.asarray(x), interpret=True),
           csr, x)
    _check(sop(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=1.5,
               beta=-0.25),
           jsop(jnp.asarray(x), y_in=jnp.asarray(y0), alpha=1.5, beta=-0.25,
                interpret=True), csr, x, y0, 1.5, -0.25)
    X = rs.uniform(-1, 1, (n, 2)).astype(np.float32)
    Y = sop.mm(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, csr.spmm_gold(X), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(Y, np.asarray(jsop.mm(jnp.asarray(X),
                                                     interpret=True)),
                               rtol=3e-4, atol=3e-4)


def test_hotcold_operator_matches_gold():
    j = _powerlaw_cols()
    csr = _port(j)
    op = S.build_hotcold_operator(csr, device="cpu")
    jop = J.build_hotcold_operator(j)
    assert op.num_hot_windows > 0 and op.num_hot_windows == \
        jop.num_hot_windows
    assert (op.hot_nnz, op.cold_nnz) == (jop.hot_nnz, jop.cold_nnz)
    assert op.hot_nnz + op.cold_nnz == csr.num_nonzeros
    np.testing.assert_array_equal(op._xidx.numpy(), np.asarray(jop._xidx))
    x, y0 = _vecs(csr, 0)
    y = op(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=1.5,
           beta=-0.5)
    jy = jop(jnp.asarray(x), y_in=jnp.asarray(y0), alpha=1.5, beta=-0.5,
             interpret=True)
    _check(y, jy, csr, x, y0, 1.5, -0.5)
    # the plan is the cold part's; shape and row norm are the matrix's
    assert op.plan.num_nonzeros == op.cold_nnz
    assert op.shape == (csr.num_rows, csr.num_cols)


def test_hotcold_operator_all_hot():
    j = _all_hot()
    csr = _port(j)
    op = S.build_hotcold_operator(csr, coverage=1.0, min_gain=0.0,
                                  device="cpu")
    jop = J.build_hotcold_operator(j, coverage=1.0, min_gain=0.0)
    assert op.num_hot_windows > 0 and op.cold_nnz == 0
    assert op.cold_op is None and op.plan is op.hot_op.plan
    x, _ = _vecs(csr, 3)
    _check(op(torch.from_numpy(x)), jop(jnp.asarray(x), interpret=True),
           csr, x)


def test_hotcold_operator_no_hot_set():
    """A flat profile selects nothing: one cold launch, the JAX result."""
    j = _flat(n=6000)
    csr = _port(j)
    op = S.build_hotcold_operator(csr, device="cpu")
    jop = J.build_hotcold_operator(j)
    assert op.num_hot_windows == 0 and op.hot_op is None
    assert "no hot set" in op.describe()
    x, y0 = _vecs(csr, 4)
    _check(op(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=0.5,
              beta=2.0),
           jop(jnp.asarray(x), y_in=jnp.asarray(y0), alpha=0.5, beta=2.0,
               interpret=True), csr, x, y0, 0.5, 2.0)


def test_hotcold_operator_mm_matches_gold():
    j = _powerlaw_cols(n=12000, deg=6, hubs=20)
    csr = _port(j)
    op = S.build_hotcold_operator(csr, device="cpu")
    jop = J.build_hotcold_operator(j)
    X = np.random.RandomState(1).uniform(-1, 1, (csr.num_cols, 3)).astype(
        np.float32)
    _check_mm(op.mm(torch.from_numpy(X)),
              jop.mm(jnp.asarray(X), interpret=True), csr, X)


@pytest.mark.parametrize("build", ["split", "hotcold", "device"])
def test_split_builders_default_to_the_card(build):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    csr = _port(_scattered(n=500))
    fn = {"split": S.build_split_operator,
          "hotcold": S.build_hotcold_operator,
          "device": S.build_split_operator_device}[build]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(csr)


def test_split_operand_shapes_checked():
    csr = _port(_scattered(n=500))
    op = S.build_split_operator(csr, edges_chunks="quantile", num_bands=4,
                                device="cpu")
    assert op.plan.num_rows != csr.num_rows
    with pytest.raises(ValueError, match="x must have shape"):
        op(torch.zeros(csr.num_cols + 1))
    with pytest.raises(ValueError, match="y_in must have shape"):
        op(torch.zeros(csr.num_cols), y_in=torch.zeros(op.plan.num_rows),
           beta=1.0)


# ---------------------------------------------------------- device builder

def _stacked_arrays(sop):
    o = sop.op
    if torch.is_tensor(o.values):
        return (o.values.numpy(), o.row_end_offsets.numpy(),
                o.col_indices.numpy())
    return tuple(np.array(a) for a in (o.values, o.row_end_offsets,
                                       o.col_indices))


@pytest.mark.parametrize("fixture,num_bands", [
    (lambda: _scattered(n=6000, deg=7, spread=900, seed=11), 4),
    (lambda: _scattered(n=5000, deg=8, spread=1200, seed=5), 4),
    (_compact_fixture, 16),
    (lambda: _scattered(n=3000, deg=7, spread=5), 8),   # repeated edges
    (lambda: _scattered(n=3000, deg=7, spread=900), 1),  # one band
])
def test_device_split_builder_matches_jax(fixture, num_bands):
    j = fixture()
    csr = _port(j)
    op = S.build_split_operator_device(csr, num_bands=num_bands,
                                       tile_items=TILE, device="cpu")
    jop = J.build_split_operator_device(j, num_bands=num_bands,
                                        tile_items=TILE)
    assert op.num_bands == jop.num_bands
    assert op._m_pad == jop._m_pad
    assert op.band_nnz == jop.band_nnz
    assert sum(op.band_nnz) == csr.num_nonzeros
    assert op.plan.num_rows == jop.plan.num_rows
    assert op.plan.num_nonzeros == jop.plan.num_nonzeros
    for a, b in zip(_stacked_arrays(op), _stacked_arrays(jop)):
        np.testing.assert_array_equal(a, b)
    x, _ = _vecs(csr, 1)
    _check(op(torch.from_numpy(x)), jop(jnp.asarray(x)), csr, x)


def test_device_split_builder_matches_gold():
    j = _scattered(n=6000, deg=7, spread=900, seed=11)
    csr = _port(j)
    op = S.build_split_operator_device(csr, num_bands=4, device="cpu")
    assert op.num_bands >= 2
    assert sum(op.band_nnz) == csr.num_nonzeros
    assert op.plan.tile_items % 1024 == 0
    assert set(op.stage_ms) == {"upload", "edges", "order", "stack",
                                "plan_prepare"}
    assert op.convert_ms == pytest.approx(op.setup_ms - op.upload_ms)
    x, y0 = _vecs(csr, 1)
    jy = J.build_split_operator_device(j, num_bands=4)(
        jnp.asarray(x), y_in=jnp.asarray(y0), alpha=1.5, beta=-0.5)
    _check(op(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=1.5,
              beta=-0.5), jy, csr, x, y0, 1.5, -0.5)
    X = np.random.RandomState(2).uniform(-1, 1, (csr.num_cols, 2)).astype(
        np.float32)
    Y = op.mm(torch.from_numpy(X)).numpy()
    gold = csr.spmm_gold(X)
    assert np.max(np.abs(Y - gold)) / np.max(np.abs(gold)) < 1e-5
    with pytest.raises(ValueError, match="fp32-only"):
        S.build_split_operator_device(csr, dtype="float64", device="cpu")


def test_device_split_builder_band_alignment():
    csr = _port(_scattered(n=5000, deg=8, spread=1200, seed=5))
    op = S.build_split_operator_device(csr, num_bands=4, device="cpu")
    assert op.num_bands >= 2
    T = op.plan.tile_items
    m_pad = op._m_pad
    assert m_pad % 1024 == 0
    ends = op.op.row_end_offsets.numpy()
    for b in range(1, op.num_bands):
        start = int(ends[b * m_pad - 1])
        assert start % 1024 == 0
        assert (b * m_pad + start) % T == 0
    # the static total of the JAX builder: a function of the shape alone
    t0 = csr.num_nonzeros + (op.num_bands + 1) * T
    assert op.plan.num_nonzeros == t0 - (t0 + op.num_bands * m_pad) % T


def test_counts_below_is_the_compare_count():
    rs = np.random.RandomState(0)
    d = rs.randint(-5000, 5000, 20000).astype(np.int32)
    probes = np.unique(rs.randint(-6000, 6000, 300)).astype(np.int32)
    got = S._counts_below(torch.from_numpy(d), torch.from_numpy(probes))
    want = (d[:, None] < probes[None, :]).sum(axis=0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_from_stacked_over_the_jax_stack():
    """State carried across: the JAX device builder's stacked arrays, as
    numpy, wrapped by the port's from_stacked, give the JAX result."""
    j = _scattered(n=6000, deg=7, spread=900, seed=11)
    csr = _port(j)
    jop = J.build_split_operator_device(j, num_bands=4, tile_items=TILE)
    vals, ends, cols = _stacked_arrays(jop)
    stacked = CsrMatrix.from_arrays(
        jop.plan.num_rows, csr.num_cols,
        np.concatenate([[0], ends]).astype(np.int32), cols, vals)
    inner = build_operator(stacked, tile_items=TILE, device="cpu")
    op = S.SplitSpmvOperator.from_stacked(inner, jop.num_bands, jop._m_pad,
                                          csr.num_rows, jop.band_nnz, 0.0)
    assert op.abs_row_sum_max == pytest.approx(
        S._abs_row_sum_max(csr), rel=1e-12)
    x, y0 = _vecs(csr, 5)
    _check(op(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=0.75,
              beta=1.0),
           jop(jnp.asarray(x), y_in=jnp.asarray(y0), alpha=0.75, beta=1.0),
           csr, x, y0, 0.75, 1.0)
