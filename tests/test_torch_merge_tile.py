"""The tile kernel's persistent runs and launch geometry.

* merge_tile_plain with runs of 1, 2, 3 and all tiles, composed with
  carry_fixup_plain, held against the JAX package (csrmv_xla, and the Pallas
  kernel in interpret mode on the cases tests/conftest.py keeps fast) and
  against gold, with the spmv_abs_bound backward-error bound;
* merge_csrmv_plain (the fused kernel's function) at the same runs: the
  two-kernel composition's bits, and the same bounds;
* the fused wrapper on CPU tensors: the plain version, no launch counted;
  an operator on the CPU holds no ticket counter;
* the carry pairs a run leaves (one per run, the run's open row, exactly 0
  when the run ends on a row end, a hub row carried across runs);
* ops/plan.py::tile_geometry: every value type and tile size fits a block's
  227 KB, the 48 KB opt-in is flagged exactly above 48 KB, and the runs
  cover every tile once, in order, in at most one resident wave;
* the gather policies: the "l1" geometry, the policy each matrix class
  gets, and the plain version at the "l1" runs against the JAX package.

Inputs are made from a seed with numpy and handed to both packages.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
import merge_spmv_tpu.ops.csrmv_xla as jx
from merge_spmv_tpu.ops.csrmv_pallas import csrmv_pallas
from merge_spmv_tpu.ops.plan import make_plan as jmake_plan
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops import plan as P
from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils.compare import compare_results

# the JAX kernel tests' corner cases (tests/test_csrmv_pallas.py:47-61)
# and the extras tests/test_torch_cuda.py runs on the card
CASES = {
    "grid2d": lambda: jcoo.CooMatrix.grid2d(20),
    "wheel_hub_spans_tiles": lambda: jcoo.CooMatrix.wheel(3000),
    "empty_rows": lambda: jcoo.CooMatrix(900, 64, rows=[5, 5, 850],
                                         cols=[0, 63, 3], vals=[1., 2., 3.]),
    "leading_trailing_empty": lambda: jcoo.CooMatrix(
        2100, 32, rows=[1050], cols=[7], vals=[2.0]),
    "duplicates": lambda: jcoo.CooMatrix(4, 4, rows=[1, 1, 1],
                                         cols=[2, 2, 2], vals=[1., 2., 3.]),
    "powerlaw": lambda: jcoo.CooMatrix.random_powerlaw(800, 700, 6000,
                                                       seed=3),
    "tile_boundary": lambda: jcoo.CooMatrix.random_uniform(600, 128, 8,
                                                           seed=1),
    "nnz0": lambda: jcoo.CooMatrix(700, 9, rows=[], cols=[], vals=[]),
    "one_col": lambda: jcoo.CooMatrix(6, 1, rows=[0, 2, 2, 5],
                                      cols=[0, 0, 0, 0],
                                      vals=[1., 2., 3., 4.]),
}
# run through the Pallas kernel in interpret mode (conftest keeps these fast)
INTERPRET_CASES = ("empty_rows", "duplicates", "one_col")
TILE = 256   # many tiles per case, so that runs of 2 and 3 hold several


@functools.lru_cache(maxsize=None)
def _case(name):
    """A JAX-package CSR, its port twin on identical arrays, x and y_in
    (signed, from a seed), and the JAX package's y = 2.5 A x - 0.75 y_in."""
    j = jcsr.CsrMatrix.from_coo(CASES[name]())
    rs = np.random.RandomState(11)
    j.values = rs.uniform(-1, 1, j.num_nonzeros).astype(np.float32)
    x = rs.uniform(-1, 1, j.num_cols).astype(np.float32)
    yi = rs.uniform(-1, 1, j.num_rows).astype(np.float32)
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    v, re_, ci = j.to_device(dtype=np.float32)
    if name in INTERPRET_CASES:
        plan = jmake_plan(j.num_rows, j.num_cols, j.num_nonzeros,
                          dtype=np.float32, tile_items=1024,
                          backend="pallas")
        want = csrmv_pallas(plan, v, re_, ci, jnp.asarray(x),
                            y_in=jnp.asarray(yi), alpha=2.5, beta=-0.75,
                            interpret=True)
    else:
        want = jx.csrmv_xla(v, re_, ci, jnp.asarray(x), y_in=jnp.asarray(yi),
                            alpha=2.5, beta=-0.75)
    return j, t, x, yi, np.asarray(want)


def _tensors(t, x, yi=None, dtype=torch.float32, tile_items=TILE):
    v, re_, ci = t.to_device(dtype=dtype, device="cpu")
    tr, tn = merge_tile_coordinates(re_, t.num_nonzeros, tile_items)
    xt = torch.from_numpy(x).to(dtype)
    yt = None if yi is None else torch.from_numpy(yi).to(dtype)
    return (v, ci, re_, xt, tr, tn), yt


def _assert_close(got, want, bound, context):
    idx = compare_results(got, want, verbose=False, abs_bound=bound)
    assert idx is None, (f"{context}: [{idx}] got {got.ravel()[idx]!r} "
                         f"want {want.ravel()[idx]!r}")


# ---------------------------------------------------------------------- #
# Runs of tiles: the plain version against the JAX package and gold
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("runs", [1, 2, 3, "all"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_runs_vs_jax_and_gold(name, runs):
    j, t, x, yi, want = _case(name)
    args, yt = _tensors(t, x, yi)
    num_tiles = args[4].shape[0] - 1
    run_tiles = num_tiles if runs == "all" else runs
    y, crow, cval = K.merge_tile_plain(*args, TILE, yt, 2.5, -0.75,
                                       run_tiles)
    # one pair per run: the row open at the run's end
    ends = P.run_ends(num_tiles, run_tiles)
    assert crow.dtype == torch.int32
    assert torch.equal(crow, args[4][ends])
    assert cval.shape == (-(-num_tiles // run_tiles),)
    got = K.carry_fixup_plain(y, crow, cval, 2.5).numpy()
    bound = j.spmv_abs_bound(x, yi, 2.5, -0.75)
    _assert_close(got, want, bound, f"{name} runs={runs} vs jax")
    _assert_close(got, j.spmv_gold(x, yi, 2.5, -0.75), bound,
                  f"{name} runs={runs} vs gold")


@pytest.mark.parametrize("runs", [1, 2, 3, "all"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_plain_is_the_two_kernel_plain(name, runs):
    """merge_csrmv_plain at runs of run_tiles gives the bits of
    merge_tile_plain then carry_fixup_plain at those runs, within the
    bound of the JAX package's result and of gold."""
    j, t, x, yi, want = _case(name)
    args, yt = _tensors(t, x, yi)
    num_tiles = args[4].shape[0] - 1
    run_tiles = num_tiles if runs == "all" else runs
    fused = K.merge_csrmv_plain(*args, TILE, yt, 2.5, -0.75, run_tiles)
    two = K.carry_fixup_plain(*K.merge_tile_plain(*args, TILE, yt, 2.5,
                                                  -0.75, run_tiles), 2.5)
    assert torch.equal(fused, two)
    bound = j.spmv_abs_bound(x, yi, 2.5, -0.75)
    _assert_close(fused.numpy(), want, bound, f"{name} runs={runs} vs jax")
    _assert_close(fused.numpy(), j.spmv_gold(x, yi, 2.5, -0.75), bound,
                  f"{name} runs={runs} vs gold")


@pytest.mark.parametrize("run_tiles", [None, 2])
@pytest.mark.parametrize("name", ["wheel_hub_spans_tiles", "powerlaw",
                                  "leading_trailing_empty", "tile_boundary",
                                  "nnz0"])
def test_fused_wrapper_on_cpu_runs_the_plain_version(name, run_tiles):
    """On CPU tensors merge_csrmv is merge_csrmv_plain at the geometry's
    runs (or the forced ones), and counts no launch."""
    j, t, x, yi, _ = _case(name)
    args, yt = _tensors(t, x, yi)
    num_tiles = args[4].shape[0] - 1
    run = (P.tile_geometry(num_tiles, TILE, "float32").run_tiles
           if run_tiles is None else run_tiles)
    K.reset_launches()
    got = K.merge_csrmv(*args, TILE, yt, 2.5, -0.75, run_tiles=run_tiles)
    assert not any(K.LAUNCHES.values())
    assert torch.equal(got, K.merge_csrmv_plain(*args, TILE, yt, 2.5, -0.75,
                                                run))
    _assert_close(got.numpy(), j.spmv_gold(x, yi, 2.5, -0.75),
                  j.spmv_abs_bound(x, yi, 2.5, -0.75), name)


@pytest.mark.parametrize("name", ["wheel_hub_spans_tiles", "powerlaw",
                                  "nnz0"])
def test_cpu_operator_holds_no_ticket_counter(name):
    """The fused kernel's ticket counter exists on the card only: an
    operator on the CPU holds none, and its op(x) is the plain version at
    the geometry's runs."""
    j, t, x, yi, _ = _case(name)
    assert K.ticket_counter("cpu") is None
    op = build_operator(t, tile_items=TILE, device="cpu")
    assert op.tickets is None
    args, yt = _tensors(t, x, yi)
    run = P.tile_geometry(args[4].shape[0] - 1, TILE, "float32").run_tiles
    got = op(torch.from_numpy(x), torch.from_numpy(yi), 2.5, -0.75)
    assert torch.equal(got, K.merge_csrmv_plain(*args, TILE, yt, 2.5, -0.75,
                                                run))


@pytest.mark.parametrize("name,run_tiles", [
    ("wheel_hub_spans_tiles", 5), ("powerlaw", 4), ("tile_boundary", 3)])
def test_run_count_not_dividing_the_tiles(name, run_tiles):
    """The last run is shorter; its pair is the matrix's end, and a run's
    carry is the sum of its tiles' carries of the row it leaves open."""
    j, t, x, _, _ = _case(name)
    args, _ = _tensors(t, x)
    num_tiles = args[4].shape[0] - 1
    assert num_tiles % run_tiles
    _, crow, cval = K.merge_tile_plain(*args, TILE, run_tiles=run_tiles)
    _, crow1, cval1 = K.merge_tile_plain(*args, TILE, run_tiles=1)
    assert crow.shape[0] == num_tiles // run_tiles + 1
    assert int(crow[-1]) == t.num_rows
    for b in range(crow.shape[0]):
        tiles = slice(b * run_tiles, min((b + 1) * run_tiles, num_tiles))
        same = crow1[tiles] == crow[b]
        np.testing.assert_allclose(float(cval[b]),
                                   float(cval1[tiles][same].sum()),
                                   rtol=1e-5, atol=1e-6)
    y, _, _ = K.merge_tile_plain(*args, TILE, run_tiles=run_tiles)
    got = K.carry_fixup_plain(y, crow, cval, 1.0).numpy()
    _assert_close(got, j.spmv_gold(x), j.spmv_abs_bound(x), name)


def test_runs_ending_on_row_ends_carry_exactly_zero():
    """9 merge items per row: 2304-item tiles, and so runs of 2 tiles, end
    exactly on row ends; such a run's carry is exactly 0."""
    _, t, x, _, _ = _case("tile_boundary")
    args, _ = _tensors(t, x, tile_items=2304)
    tr, tn, re_ = args[4], args[5], args[2]
    _, crow, cval = K.merge_tile_plain(*args, 2304, run_tiles=2)
    ends = P.run_ends(tr.shape[0] - 1, 2)
    last = (tr[ends] - 1).clamp(min=0).long()
    on_row_end = (re_[last] == tn[ends]) & (tr[ends] < t.num_rows)
    assert on_row_end.any()
    assert (cval[on_row_end] == 0).all()


def test_hub_row_carried_across_runs():
    """The wheel's hub row spans many 256-item tiles: with runs of 2 it
    leaves a positive carry from several runs, and the fix-up restores its
    full sum."""
    j, t, x, _, _ = _case("wheel_hub_spans_tiles")
    t = t.astype(np.float32)
    t.values = np.abs(t.values)
    x = np.abs(x)
    args, _ = _tensors(t, x)
    y, crow, cval = K.merge_tile_plain(*args, TILE, run_tiles=2)
    hub = crow == 0
    assert int(hub.sum()) > 2 and bool((cval[hub] > 0).all())
    got = K.carry_fixup_plain(y, crow, cval, 1.0).numpy()
    _assert_close(got, t.spmv_gold(x), t.spmv_abs_bound(x), "hub")


def test_cpu_wrapper_takes_the_geometry_runs():
    """On the CPU the wrapper runs the plain version with the runs the
    geometry gives for an H100; float64 tiles of 4096 fit one block per
    SM, so a grid2d(400) takes runs of 2 tiles."""
    t = CsrMatrix.from_coo(CooMatrix.grid2d(400)).astype(np.float64)
    rs = np.random.RandomState(5)
    t.values = rs.uniform(-1, 1, t.num_nonzeros)
    x = rs.uniform(-1, 1, t.num_cols)
    args, _ = _tensors(t, x, dtype=torch.float64, tile_items=4096)
    num_tiles = args[4].shape[0] - 1
    geo = P.tile_geometry(num_tiles, 4096, "float64")
    assert geo.run_tiles == 2 and geo.grid < num_tiles
    K.reset_launches()
    _, crow, _ = K.merge_tile(*args, 4096)
    assert crow.shape[0] == geo.grid
    y = K.merge_csrmv(*args, 4096)
    assert K.LAUNCHES == {"merge_tile": 0, "merge_tile_fused": 0,
                          "carry_fixup": 0, "merge_tile_mm": 0}
    np.testing.assert_allclose(y.numpy(), t.spmv_gold(x), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="run_tiles"):
        K.merge_tile(*args, 4096, run_tiles=0)


# ---------------------------------------------------------------------- #
# Launch geometry
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("tile_items", [256, 512, 1024, 2048, 2304, 4096])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_geometry_fits_the_card(dtype, tile_items):
    g = P.tile_geometry(3389, tile_items, dtype)
    assert g.threads * P.ITEMS_PER_THREAD == tile_items
    assert g.stages == P.STAGES
    assert g.shared_bytes == P.tile_shared_bytes(tile_items, dtype)
    assert g.shared_bytes <= P.BLOCK_SHARED_MAX
    assert g.opt_in == (g.shared_bytes > P.BLOCK_SHARED_DEFAULT)
    assert g.blocks_per_sm >= 1
    assert g.blocks_per_sm * (g.shared_bytes + P.BLOCK_RESERVED_SHARED) \
        <= P.SM_SHARED_BYTES
    assert g.blocks_per_sm * g.threads <= P.SM_THREADS
    # bfloat16 computes in float32: the same block
    if dtype == "bfloat16":
        assert g == P.tile_geometry(3389, tile_items, "float32")


@pytest.mark.parametrize("num_tiles,num_sms,blocks_per_sm", [
    (1, 132, None), (7, 3, 2), (660, 132, 5), (3389, 132, None),
    (3389, 132, 4), (100_003, 132, 1), (5, 132, 1)])
def test_runs_cover_every_tile_once_in_order(num_tiles, num_sms,
                                             blocks_per_sm):
    g = P.tile_geometry(num_tiles, 2048, "float32", num_sms=num_sms,
                        blocks_per_sm=blocks_per_sm)
    resident = g.blocks_per_sm * num_sms
    assert 1 <= g.grid <= min(num_tiles, resident)
    # the fewest tiles per run that fill one wave
    assert (g.run_tiles - 1) * resident < num_tiles <= g.run_tiles * resident
    ends = P.run_ends(num_tiles, g.run_tiles).tolist()
    assert len(ends) == g.grid
    starts = [0] + ends[:-1]
    covered = [t for s, e in zip(starts, ends) for t in range(s, e)]
    assert covered == list(range(num_tiles))
    assert all(e - s == g.run_tiles for s, e in zip(starts[:-1], ends[:-1]))


def test_geometry_takes_the_cards_occupancy_and_refuses_bad_input():
    g = P.tile_geometry(3389, 2048, "float32")
    assert P.tile_geometry(3389, 2048, "float32", blocks_per_sm=2).grid \
        < g.grid
    # a higher figure than threads and shared memory allow is ignored
    assert P.tile_geometry(3389, 2048, "float32", blocks_per_sm=99) == g
    with pytest.raises(ValueError, match="tile_items"):
        P.tile_geometry(10, 1000, "float32")
    with pytest.raises(ValueError, match="positive"):
        P.tile_geometry(0, 2048, "float32")
    with pytest.raises(ValueError, match="run_tiles"):
        P.run_ends(10, 0)
    plan = P.make_plan(1_000_000, 1_000_000, 5_940_000, device="cpu")
    assert plan.threads_per_block == g.threads


# ---------------------------------------------------------------------- #
# Gather policies: the geometry of each, the choice per matrix class, and
# the plain version at the "l1" runs against the JAX package
# ---------------------------------------------------------------------- #

def _scattered_class(kind):
    """Small members of the matrix classes the policies are chosen for,
    from the generators of the full-size ones (the port's
    bench/matrices.py, copies of the JAX side's benchmark generators),
    as a JAX-package CSR."""
    from merge_spmv_tpu_torch.bench.matrices import make_circuit_like, rmat
    rs = np.random.RandomState(6)
    if kind == "circuit":
        n = 40_000
        rows, cols, vals = make_circuit_like(n, 400_000, seed=2)
    elif kind == "kron":
        rows, cols, vals = rmat(14, 300_000, 16, np.float64)
        n = int(max(rows.max(), cols.max())) + 1
    elif kind == "grid3d":
        return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix.grid3d(30)).astype(
            np.float32)
    elif kind == "wheel":
        return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix.wheel(20_000)).astype(
            np.float32)
    else:   # a DIA leftover: few scattered nonzeros over many rows
        n = 200_000
        rows, cols = rs.randint(0, n, 2_000), rs.randint(0, n, 2_000)
        vals = rs.uniform(-1, 1, rows.size)
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(n, n, rows, cols, vals)
                                   ).astype(np.float32)


@pytest.mark.parametrize("kind,want", [
    ("circuit", "l1"), ("kron", "l1"), ("grid3d", "stream"),
    ("wheel", "stream"), ("leftover", "stream")])
def test_policy_per_class(kind, want):
    """The scattered classes gather more sectors than twice their streams'
    bytes and take "l1"; the stencil, the wheel and a DIA leftover do
    not.  The statistic is the same on a numpy array and a tensor."""
    j = _scattered_class(kind)
    spread = P.gather_sectors_per_nonzero(j.col_indices)
    assert spread == P.gather_sectors_per_nonzero(
        torch.from_numpy(j.col_indices))
    assert 1 / P.WARP <= spread <= 1
    assert P.gather_policy(j.num_rows, j.num_nonzeros, j.col_indices) == want
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    op = build_operator(t, device="cpu")
    assert op.plan.policy == want and f"gather={want}" in op.describe()


def test_gather_statistic_counts_distinct_sectors():
    """One request of 32 consecutive columns reads 4 float32 sectors (8
    floats each); 32 columns 8 apart read 32; float64 sectors hold 4."""
    dense = np.arange(32, dtype=np.int32)
    assert P.gather_sectors_per_nonzero(dense) == 4 / 32
    assert P.gather_sectors_per_nonzero(dense * 8) == 1.0
    assert P.gather_sectors_per_nonzero(dense, "float64") == 8 / 32
    assert P.gather_sectors_per_nonzero(np.zeros(0, np.int32)) == 0.0


@pytest.mark.parametrize("tile_items", [256, 1024, 2048, 4096])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_l1_geometry_fits_the_l1_carveout(dtype, tile_items):
    """The "l1" policy launches the blocks that fit the smallest carveout
    holding one default tile (64 KB in float32, 100 KB in float64: two
    blocks of the 1024-item tile, one of the default), at least one, with
    the same block as "stream"; its runs cover every tile once, in
    order."""
    carve = P.l1_carveout_bytes(dtype)
    assert carve == (64 if dtype == "float32" else 100) * 1024
    assert P.tile_shared_bytes(P.DEFAULT_TILE_ITEMS, dtype) \
        + P.BLOCK_RESERVED_SHARED <= carve
    for num_tiles in (1, 131, 3389, 100_003):
        g = P.tile_geometry(num_tiles, tile_items, dtype, policy="l1")
        s = P.tile_geometry(num_tiles, tile_items, dtype)
        per_block = g.shared_bytes + P.BLOCK_RESERVED_SHARED
        assert g.blocks_per_sm == max(1, min(carve // per_block,
                                             s.blocks_per_sm))
        assert (g.threads, g.shared_bytes) == (s.threads, s.shared_bytes)
        resident = g.blocks_per_sm * P.H100_SMS
        assert g.grid <= min(num_tiles, resident)
        assert (g.run_tiles - 1) * resident < num_tiles \
            <= g.run_tiles * resident
        ends = P.run_ends(num_tiles, g.run_tiles)
        assert len(ends) == g.grid and int(ends[-1]) == num_tiles
    if tile_items == P.L1_TILE_ITEMS:
        assert g.blocks_per_sm == 2
    with pytest.raises(ValueError, match="policy"):
        P.tile_geometry(10, tile_items, dtype, policy="wide")


@pytest.mark.parametrize("kind", ["circuit", "kron"])
def test_l1_runs_vs_jax_and_gold(kind):
    """The plain version at the "l1" runs (132 blocks, long runs) against
    the JAX package's csrmv_xla and gold, within the spmv_abs_bound
    backward-error bound; the CPU operator runs exactly it."""
    j = _scattered_class(kind)
    rs = np.random.RandomState(12)
    x = rs.uniform(-1, 1, j.num_cols).astype(np.float32)
    yi = rs.uniform(-1, 1, j.num_rows).astype(np.float32)
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    args, yt = _tensors(t, x, yi)
    num_tiles = args[4].shape[0] - 1
    g = P.tile_geometry(num_tiles, TILE, "float32", policy="l1")
    assert g.run_tiles > 1
    got = K.merge_csrmv_plain(*args, TILE, yt, 2.5, -0.75, g.run_tiles)
    two = K.carry_fixup_plain(*K.merge_tile_plain(
        *args, TILE, yt, 2.5, -0.75, g.run_tiles), 2.5)
    assert torch.equal(got, two)
    v, re_, ci = j.to_device(dtype=np.float32)
    want = np.asarray(jx.csrmv_xla(v, re_, ci, jnp.asarray(x),
                                   y_in=jnp.asarray(yi), alpha=2.5,
                                   beta=-0.75))
    bound = j.spmv_abs_bound(x, yi, 2.5, -0.75)
    _assert_close(got.numpy(), want, bound, f"{kind} l1 vs jax")
    _assert_close(got.numpy(), j.spmv_gold(x, yi, 2.5, -0.75), bound,
                  f"{kind} l1 vs gold")
    op = build_operator(t, tile_items=TILE, device="cpu")
    assert op.plan.policy == "l1"
    assert torch.equal(op(torch.from_numpy(x), torch.from_numpy(yi), 2.5,
                          -0.75), got)
