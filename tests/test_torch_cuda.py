"""The CUDA kernels (merge path, DIA, the op-class probe) against their
plain PyTorch versions, on the card, and the operators built on them (the
split and hot/cold operators, the device split builder, the autotuner),
the solvers' CUDA-graph blocks, two gloo ranks sharing the card, and two
north-star configurations at full size (cant_class in float64, SpMM on
the pdb1HYS class) against gold and cuSPARSE.
Every test needs an NVIDIA GPU with nvcc and skips without one; run them
there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX, which the card's machine
need not have; this file imports only the port).
"""

import dataclasses

import numpy as np
import pytest
import torch

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops import dia_cuda as D
from merge_spmv_tpu_torch.ops.csrmv import csrmv
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops import plan as PL
from merge_spmv_tpu_torch.ops.plan import make_plan
from merge_spmv_tpu_torch.tools import sm_ceiling as P
from merge_spmv_tpu_torch.utils.compare import compare_results

pytestmark = pytest.mark.cuda

CASES = {
    "grid2d_small": lambda: CooMatrix.grid2d(6),
    "grid2d": lambda: CooMatrix.grid2d(20),
    "wheel_single_tile": lambda: CooMatrix.wheel(100),
    "wheel_hub_spans_tiles": lambda: CooMatrix.wheel(3000),
    "empty_rows": lambda: CooMatrix(900, 64, rows=[5, 5, 850],
                                    cols=[0, 63, 3], vals=[1., 2., 3.]),
    "leading_trailing_empty": lambda: CooMatrix(2100, 32, rows=[1050],
                                                cols=[7], vals=[2.0]),
    "duplicates": lambda: CooMatrix(4, 4, rows=[1, 1, 1], cols=[2, 2, 2],
                                    vals=[1., 2., 3.]),
    "powerlaw": lambda: CooMatrix.random_powerlaw(800, 700, 6000, seed=3),
    "dense_rows": lambda: CooMatrix.dense(50, 60),
    "multi_chunk_cols": lambda: CooMatrix.random_uniform(300, 6000, 8,
                                                         seed=9),
    "tile_boundary": lambda: CooMatrix.random_uniform(600, 128, 8, seed=1),
    "nnz0": lambda: CooMatrix(700, 9, rows=[], cols=[], vals=[]),
    "one_col": lambda: CooMatrix(6, 1, rows=[0, 2, 2, 5], cols=[0, 0, 0, 0],
                                 vals=[1., 2., 3., 4.]),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def _setup(name, dev, tile_items, dtype=torch.float32, signed=False,
           seed=0):
    csr = CsrMatrix.from_coo(CASES[name]())
    rs = np.random.RandomState(seed)
    lo = -1.0 if signed else 0.1
    csr.values = rs.uniform(lo, 1, csr.num_nonzeros)
    x = rs.uniform(lo, 1, csr.num_cols)
    y_in = rs.uniform(lo, 1, csr.num_rows)
    v, re_, ci = csr.to_device(dtype=dtype, device=dev)
    tr, tn = merge_tile_coordinates(re_, csr.num_nonzeros, tile_items)
    as_t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    return csr, (v, ci, re_), as_t(x), as_t(y_in), (tr, tn), x, y_in


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile_items", [256, 1024, 2304, 4096])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_vs_plain_and_gold(card, name, tile_items, dtype):
    """The fused kernel (op(x)'s one launch) against the two kernels at
    its runs (bit for bit), the plain version and gold."""
    csr, arrs, x, y_in, tiles, xh, yh = _setup(name, card, tile_items,
                                               dtype=dtype, signed=True)
    args = (*arrs, x, *tiles, tile_items, y_in, 2.5, -0.75)
    got = K.merge_csrmv(*args)
    run = K.launch_geometry(tiles[0].shape[0] - 1, tile_items, dtype, card,
                            fused=True).run_tiles
    two = K.carry_fixup(*K.merge_tile(*args, run_tiles=run), 2.5)
    plain = K.merge_csrmv_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, two)
    if dtype == torch.float64:
        gold = csr.spmv_gold(xh, yh, 2.5, -0.75)
    else:
        gold = csr.astype(np.float32).spmv_gold(
            xh.astype(np.float32), yh.astype(np.float32), 2.5, -0.75)
    bound = csr.spmv_abs_bound(xh, yh, 2.5, -0.75)
    assert got.dtype == dtype
    for other in (plain.cpu().numpy(), gold):
        assert compare_results(got.cpu().numpy(), other, verbose=False,
                               abs_bound=bound) is None


@pytest.mark.parametrize("name", ["wheel_hub_spans_tiles", "powerlaw",
                                  "leading_trailing_empty"])
def test_tile_kernel_carries_match_plain(card, name):
    """One carry pair per run of the card's geometry, as the plain version
    leaves them with the same runs."""
    _, arrs, x, _, tiles, _, _ = _setup(name, card, 256)
    geo = K.launch_geometry(tiles[0].shape[0] - 1, 256, torch.float32, card)
    yk, rk, vk = K.merge_tile(*arrs, x, *tiles, 256)
    yp, rp, vp = K.merge_tile_plain(*arrs, x, *tiles, 256,
                                    run_tiles=geo.run_tiles)
    assert rk.shape == (geo.grid,)
    assert torch.equal(rk, rp)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yk, yp, rtol=1e-5, atol=1e-5)


def _big(kind):
    """Matrices that make runs and their carries matter at the card's
    geometry: only empty rows over many tiles, and a hub row of 200,000
    nonzeros that spans more runs than the forced run counts below."""
    rs = np.random.RandomState(3)
    if kind == "empty":
        return CsrMatrix.from_coo(CooMatrix(300_000, 50, rows=[], cols=[],
                                            vals=[]))
    n = 40_000
    rows = np.r_[np.full(200_000, 7), rs.randint(0, n, 3 * n)]
    cols = rs.randint(0, n, rows.size)
    return CsrMatrix.from_coo(CooMatrix(n, n, rows, cols,
                                        rs.uniform(-1, 1, rows.size)))


@pytest.mark.parametrize("run_tiles", [None, 1, 3, "one_block"])
@pytest.mark.parametrize("kind", ["empty", "hub"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forced_runs_vs_plain_and_gold(card, kind, run_tiles, dtype):
    """G forced to num_tiles (runs of 1), to 1 (one block walks every
    tile), runs of 3, and the card's own geometry."""
    csr = _big(kind)
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, csr.num_cols)
    v, re_, ci = csr.to_device(dtype=dtype, device=card)
    tr, tn = merge_tile_coordinates(re_, csr.num_nonzeros, 256)
    num_tiles = tr.shape[0] - 1
    run = num_tiles if run_tiles == "one_block" else run_tiles
    xd = torch.from_numpy(x).to(card, dtype)
    y, crow, cval = K.merge_tile(v, ci, re_, xd, tr, tn, 256, run_tiles=run)
    geo = K.launch_geometry(num_tiles, 256, dtype, card)
    run = geo.run_tiles if run is None else run
    assert crow.shape == (-(-num_tiles // run),)
    yp, rp, vp = K.merge_tile_plain(v, ci, re_, xd, tr, tn, 256,
                                    run_tiles=run)
    assert torch.equal(crow, rp)
    got = K.carry_fixup(y, crow, cval)
    # the fused kernel at the same runs: the same bits, beyond one wave
    assert torch.equal(K.merge_csrmv(v, ci, re_, xd, tr, tn, 256,
                                     run_tiles=run), got)
    got = got.cpu().numpy()
    gold = csr.astype(np.float64).spmv_gold(x)
    assert compare_results(got, gold, verbose=False,
                           abs_bound=csr.spmv_abs_bound(x)) is None
    if kind == "hub" and crow.shape[0] > 1:   # the hub spans several runs
        assert int((crow == 7).sum()) >= 2


def test_unaligned_operands(card):
    """Views that start 4 bytes past a 16-byte boundary: every tile's
    copy window starts and ends inside a 16-byte unit."""
    csr, (v, ci, re_), x, y_in, _, xh, yh = _setup("powerlaw", card, 1024,
                                                   signed=True)

    def shifted(t):
        pad = torch.zeros(t.shape[0] + 1, dtype=t.dtype, device=t.device)
        pad[1:] = t
        return pad[1:]

    vs, cs, rs_, xs, ys = map(shifted, (v, ci, re_, x, y_in))
    assert all(t.data_ptr() % 16 for t in (vs, cs, rs_))
    tr, tn = merge_tile_coordinates(rs_, csr.num_nonzeros, 1024)
    got = K.merge_csrmv(vs, cs, rs_, xs, tr, tn, 1024, ys, 2.5, -0.75)
    want = K.merge_csrmv(v, ci, re_, x, tr, tn, 1024, y_in, 2.5, -0.75)
    assert torch.equal(got, want)
    run = K.launch_geometry(tr.shape[0] - 1, 1024, torch.float32, card,
                            fused=True).run_tiles
    two = K.carry_fixup(*K.merge_tile(vs, cs, rs_, xs, tr, tn, 1024, ys,
                                      2.5, -0.75, run_tiles=run), 2.5)
    assert torch.equal(got, two)
    gold = csr.astype(np.float32).spmv_gold(
        xh.astype(np.float32), yh.astype(np.float32), 2.5, -0.75)
    assert compare_results(got.cpu().numpy(), gold, verbose=False,
                           abs_bound=csr.spmv_abs_bound(xh, yh, 2.5,
                                                        -0.75)) is None


@pytest.mark.parametrize("policy", ["stream", "l1"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tile_items", [256, 1024, 2048, 2304, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_geometry_matches_the_card(card, dtype, tile_items, fused, policy):
    """The card's occupancy of each instantiation (registers and its
    carveout counted) admits the geometry's blocks, and the launcher
    accepts its shared-memory size."""
    blocks, regs = K.kernel_occupancy(dtype, tile_items, card, fused, policy)
    geo = K.launch_geometry(10_000, tile_items, dtype, card, fused, policy)
    assert 1 <= geo.blocks_per_sm <= max(blocks, 1) and regs > 0
    if policy == "l1":
        assert geo.blocks_per_sm == 1 or geo.blocks_per_sm * (
            geo.shared_bytes + 1024) <= PL.l1_carveout_bytes(dtype)
    props = torch.cuda.get_device_properties(card)
    assert geo.grid <= geo.blocks_per_sm * props.multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile_items", [256, 2048, 4096])
@pytest.mark.parametrize("name", ["wheel_hub_spans_tiles", "powerlaw",
                                  "multi_chunk_cols", "empty_rows",
                                  "nnz0"])
def test_l1_policy_vs_plain_and_gold(card, name, tile_items, dtype):
    """The "l1" gather policy's instantiation (the blocks that fit its
    own small carveout): fused bit for bit the two kernels at its runs,
    and within the bound of the plain version and gold."""
    csr, arrs, x, y_in, tiles, xh, yh = _setup(name, card, tile_items,
                                               dtype=dtype, signed=True)
    args = (*arrs, x, *tiles, tile_items, y_in, 2.5, -0.75)
    geo = K.launch_geometry(tiles[0].shape[0] - 1, tile_items, dtype, card,
                            fused=True, policy="l1")
    props = torch.cuda.get_device_properties(card)
    assert geo.grid <= geo.blocks_per_sm * props.multi_processor_count
    assert geo.blocks_per_sm == 1 or geo.blocks_per_sm * (
        geo.shared_bytes + 1024) <= PL.l1_carveout_bytes(dtype)
    got = K.merge_csrmv(*args, policy="l1")
    two = K.carry_fixup(*K.merge_tile(*args, run_tiles=geo.run_tiles,
                                      policy="l1"), 2.5)
    plain = K.merge_csrmv_plain(*args, run_tiles=geo.run_tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, two)
    assert torch.equal(got, K.merge_csrmv(*args, policy="l1"))
    bound = csr.spmv_abs_bound(xh, yh, 2.5, -0.75)
    gold = (csr.spmv_gold(xh, yh, 2.5, -0.75) if dtype == torch.float64
            else csr.astype(np.float32).spmv_gold(
                xh.astype(np.float32), yh.astype(np.float32), 2.5, -0.75))
    for other in (plain.cpu().numpy(), gold):
        assert compare_results(got.cpu().numpy(), other, verbose=False,
                               abs_bound=bound) is None


def _scattered_class(kind):
    """Small members of the two scattered-column classes, from the
    generators of the full-size ones (bench/matrices.py)."""
    from merge_spmv_tpu_torch.bench.matrices import make_circuit_like, rmat
    if kind == "circuit":
        n = 200_000
        rows, cols, vals = make_circuit_like(n, 2_000_000, seed=2)
    else:
        rows, cols, vals = rmat(16, 1_000_000, 16, np.float64)
        n = int(max(rows.max(), cols.max())) + 1
    return CsrMatrix.from_coo(CooMatrix(n, n, rows, cols, vals)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["circuit", "kron"])
def test_scattered_classes_take_the_l1_policy(card, kind):
    """The operator picks the "l1" policy for both scattered classes;
    op(x) verifies against gold, two calls are bitwise equal, the fused
    kernel equals the two kernels at its runs, and 20 graph replays then an
    eager call give the same bits."""
    csr = _scattered_class(kind)
    op = build_operator(csr)
    assert op.plan.policy == "l1", op.describe()
    rs = np.random.RandomState(5)
    xh = rs.uniform(-1, 1, csr.num_cols).astype(np.float32)
    x = torch.from_numpy(xh).to(card)
    K.reset_launches()
    eager = op(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_tile_fused"] == 1
    assert compare_results(eager.cpu().numpy(), csr.spmv_gold(xh),
                           verbose=False,
                           abs_bound=csr.spmv_abs_bound(xh)) is None
    assert torch.equal(op(x), eager)
    T = op.plan.tile_items
    run = K.launch_geometry(op.plan.num_tiles, T, torch.float32, card,
                            fused=True, policy="l1").run_tiles
    two = K.carry_fixup(*K.merge_tile(
        op.values, op.col_indices, op.row_end_offsets, x, op.tile_rows,
        op.tile_nnz, T, run_tiles=run, policy="l1"))
    assert torch.equal(two, eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(x)
    replays = []
    for _ in range(20):
        graph.replay()
        replays.append(captured.clone())
    after = op(x)
    torch.cuda.synchronize()
    assert all(torch.equal(r, eager) for r in replays)
    assert torch.equal(after, eager)


@pytest.mark.parametrize("name", ["wheel_hub_spans_tiles", "powerlaw"])
def test_float64_kernel(card, name):
    csr, arrs, x, _, tiles, xh, _ = _setup(name, card, 1024,
                                           dtype=torch.float64, seed=7)
    y = K.merge_csrmv(*arrs, x, *tiles, 1024)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.cpu().numpy(), csr.spmv_gold(xh),
                               rtol=1e-12, atol=0)


def test_repeat_calls_bitwise_equal(card):
    _, arrs, x, _, tiles, _, _ = _setup("wheel_hub_spans_tiles", card, 256,
                                        signed=True)
    a = K.merge_csrmv(*arrs, x, *tiles, 256)
    b = K.merge_csrmv(*arrs, x, *tiles, 256)
    assert torch.equal(a, b)
    # and on a matrix whose runs hold several tiles each
    csr = _big("hub").astype(np.float32)
    op = build_operator(csr)
    xd = torch.from_numpy(np.random.RandomState(6).uniform(
        -1, 1, csr.num_cols).astype(np.float32)).to(card)
    assert torch.equal(op(xd), op(xd))


def test_graph_capture_replays_the_eager_call(card):
    """op(x) captured in a CUDA graph (the tile kernel's shared memory
    above 48 KB is opted into at load, not per launch) gives the eager
    call's bits on replay."""
    csr = CsrMatrix.from_coo(CooMatrix.grid3d(30)).astype(np.float32)
    csr.values = np.random.RandomState(8).uniform(
        -1, 1, csr.num_nonzeros).astype(np.float32)
    op = build_operator(csr)
    assert K.launch_geometry(op.plan.num_tiles, op.plan.tile_items,
                             torch.float32, card).opt_in
    x = torch.ones(csr.num_cols, device=card)
    eager = op(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(x)
    x.copy_(torch.ones_like(x))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_graph_replays_then_eager_call_bitwise_equal(card, dtype):
    """20 replays of a captured op(x), then an eager call: each launch
    finds the ticket counter reset by the one before, so every result has
    the same bits."""
    csr = CsrMatrix.from_coo(CooMatrix.wheel(20_000))
    csr.values = np.random.RandomState(9).uniform(-1, 1, csr.num_nonzeros)
    op = build_operator(csr, dtype=dtype, tile_items=256)
    x = torch.from_numpy(np.random.RandomState(10).uniform(
        -1, 1, csr.num_cols)).to(card, op.values.dtype)
    eager = op(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(x)
    replays = []
    for _ in range(20):
        graph.replay()
        replays.append(captured.clone())
    after = op(x)
    torch.cuda.synchronize()
    assert all(torch.equal(r, eager) for r in replays)
    assert torch.equal(after, eager)
    assert compare_results(after.cpu().numpy(),
                           csr.spmv_gold(x.cpu().numpy()), verbose=False,
                           abs_bound=csr.spmv_abs_bound(
                               x.cpu().numpy())) is None


def _carried_rows(n, seed=12):
    """n rows of 13 nonzeros (14 merge items): at 256-item tiles with a
    block per tile, 6 tiles in 7 end inside a row, so nearly every block
    leaves a nonzero carry into a row that the next block finishes."""
    rows = np.repeat(np.arange(n), 13)
    rs = np.random.RandomState(seed)
    return CsrMatrix.from_coo(CooMatrix(n, n, rows,
                                        rs.randint(0, n, rows.size),
                                        rs.uniform(0.5, 1.5, rows.size)))


def _vectors(card, n, count, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.uniform(0.5, 1.5, n)).to(card, torch.float32)
            for _ in range(count)]


def test_fused_tail_reads_every_blocks_writes(card):
    """Many blocks (a block per tile, far beyond one resident wave)
    finishing together: the block that runs the fix-up must see every
    other block's pair and y row.  50 calls back to back, x changing from
    call to call so that a pair or y row read before its write is visible
    holds another call's value: each is bit for bit the two-kernel
    result."""
    csr = _carried_rows(60_000)
    v, re_, ci = csr.to_device(dtype=torch.float32, device=card)
    tr, tn = merge_tile_coordinates(re_, csr.num_nonzeros, 256)
    xs = _vectors(card, csr.num_cols, 8, 13)
    want = [K.carry_fixup(*K.merge_tile(v, ci, re_, x, tr, tn, 256,
                                        run_tiles=1)) for x in xs]
    _, crow, cval = K.merge_tile(v, ci, re_, xs[0], tr, tn, 256, run_tiles=1)
    assert crow.shape[0] > 3000
    assert float((cval[crow < csr.num_rows] != 0).float().mean()) > 0.8
    tickets = K.ticket_counter(card)
    torch.cuda.synchronize()
    got = [K.merge_csrmv(v, ci, re_, xs[k % len(xs)], tr, tn, 256,
                         run_tiles=1, tickets=tickets) for k in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, want[k % len(xs)]) for k, g in enumerate(got))
    assert int(tickets.item()) == 0


@pytest.mark.parametrize("policy", ["stream", "l1"])
def test_fused_tail_orders_the_last_writes(card, policy):
    """The tail's ordering at the card's own geometry of each gather
    policy (3 tiles a run):
    rows of two runs' merge items each, so every other run leaves a carry
    into a row that the next block finishes in its last tile, and that y
    row and the next pair are the last things the block writes before its
    ticket.  Every run holds the same work, so the blocks reach the tail
    together.  300 calls back to back with x changing from call to call:
    each is bit for bit the two kernels at the same runs, so no fix-up read
    a pair or a y row before its write."""
    T = 2048
    geo = K.launch_geometry(10**6, T, torch.float32, card, fused=True,
                            policy=policy)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    runs = geo.blocks_per_sm * sms
    runs -= runs % 2
    num_rows = runs // 2
    nnz_row = 6 * T - 1                 # 2 runs of 3 tiles, minus the end
    rs = np.random.RandomState(21)
    n = 200_000
    rows = np.repeat(np.arange(num_rows), nnz_row)
    csr = CsrMatrix.from_coo(CooMatrix(num_rows, n, rows,
                                       rs.randint(0, n, rows.size),
                                       rs.uniform(0.5, 1.5, rows.size)))
    v, re_, ci = csr.to_device(dtype=torch.float32, device=card)
    tr, tn = merge_tile_coordinates(re_, csr.num_nonzeros, T)
    num_tiles = tr.shape[0] - 1
    run = K.launch_geometry(num_tiles, T, torch.float32, card,
                            fused=True, policy=policy).run_tiles
    assert num_tiles == 3 * runs and run == 3
    xs = _vectors(card, n, 6, 22)
    want = [K.carry_fixup(*K.merge_tile(v, ci, re_, x, tr, tn, T,
                                        run_tiles=run, policy=policy))
            for x in xs]
    _, crow, cval = K.merge_tile(v, ci, re_, xs[0], tr, tn, T, run_tiles=run,
                                 policy=policy)
    assert crow.shape[0] == runs
    assert bool((cval[0::2] != 0).all()) and bool((cval[1::2] == 0).all())
    tickets = K.ticket_counter(card)
    torch.cuda.synchronize()
    got = [K.merge_csrmv(v, ci, re_, xs[k % len(xs)], tr, tn, T,
                         tickets=tickets, policy=policy) for k in range(300)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, want[k % len(xs)]) for k, g in enumerate(got))
    assert int(tickets.item()) == 0


@pytest.mark.parametrize("rows_a,rows_b", [(2_000, 3_000),
                                           (60_000, 200_000)])
def test_operators_on_two_streams_at_once(card, rows_a, rows_b):
    """Two operators, each with its own ticket counter, called on two
    streams with no ordering between them.  Both streams first wait on a
    GPU sleep while 40 calls queue behind it on each, so that the two
    operators' fused launches run at once: side by side when their grids
    fit the card together (the small pair), at each kernel's tail
    otherwise.  Every result is the bits of the same call made alone, and
    each counter is left at 0."""
    ops = (build_operator(_carried_rows(rows_a), tile_items=256),
           build_operator(CsrMatrix.from_coo(CooMatrix.wheel(rows_b)),
                          tile_items=256))
    xs = [_vectors(card, op.plan.num_cols, 4, 20 + i)
          for i, op in enumerate(ops)]
    want = [[op(x) for x in xk] for op, xk in zip(ops, xs)]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(card), torch.cuda.Stream(card))
    got = ([], [])
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                torch.cuda._sleep(20_000_000)   # ~10 ms of clock cycles
        for k in range(40):
            for i, (op, st) in enumerate(zip(ops, streams)):
                with torch.cuda.stream(st):
                    got[i].append(op(xs[i][k % 4]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i][k % 4])
                   for k, g in enumerate(got[i]))
        assert int(ops[i].tickets.item()) == 0


def test_fused_wrapper_refuses_a_bad_counter(card):
    csr, arrs, x, _, tiles, _, _ = _setup("powerlaw", card, 256)
    for bad in (torch.zeros(1, dtype=torch.int64, device=card),
                torch.zeros(2, dtype=torch.int32, device=card)):
        with pytest.raises((TypeError, ValueError)):
            K.merge_csrmv(*arrs, x, *tiles, 256, tickets=bad)
    with pytest.raises(ValueError, match="several devices"):
        K.merge_csrmv(*arrs, x, *tiles, 256,
                      tickets=torch.zeros(1, dtype=torch.int32))


def test_operator_counts_launches(card):
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(40)).astype(np.float32)
    op = build_operator(csr)
    K.reset_launches()
    y = op(torch.ones(csr.num_cols, device=card))
    Y = op.mm(torch.ones(csr.num_cols, 3, device=card))
    torch.cuda.synchronize()
    # one launch per op(x) (the fused kernel, no fix-up) and one K1m
    # launch for all columns of op.mm
    assert K.LAUNCHES == {"merge_tile": 0, "merge_tile_fused": 1,
                          "carry_fixup": 0, "merge_tile_mm": 1}
    gold = csr.spmv_gold(np.ones(csr.num_cols, np.float32))
    np.testing.assert_array_equal(y.cpu().numpy(), gold)
    np.testing.assert_array_equal(Y[:, 2].cpu().numpy(), gold)


def test_operator_bfloat16(card):
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(30))
    op = build_operator(csr, dtype="bfloat16")
    y = op(torch.ones(csr.num_cols, dtype=torch.bfloat16, device=card))
    assert y.dtype == torch.bfloat16
    gold = csr.astype(np.float32).spmv_gold(np.ones(csr.num_cols,
                                                    np.float32))
    assert np.max(np.abs(y.float().cpu().numpy() - gold)) == 0.0


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    _, (v, ci, re_), x, _, (tr, tn), _, _ = _setup("powerlaw", card, 1024)
    with pytest.raises(TypeError):
        K.merge_tile(v, ci.long(), re_, x, tr, tn, 1024)
    with pytest.raises(TypeError):
        K.merge_tile(v.to(torch.bfloat16), ci, re_, x.to(torch.bfloat16),
                     tr, tn, 1024)
    with pytest.raises(ValueError):
        K.merge_tile(v, ci, re_, x, tr, tn, 1000)
    with pytest.raises(ValueError):
        K.merge_tile(v, ci, re_, torch.stack([x, x], 1)[:, 0], tr, tn, 1024)
    with pytest.raises(ValueError):
        K.merge_tile(v, ci, re_, x.cpu(), tr, tn, 1024)
    with pytest.raises(ValueError, match="run_tiles"):
        K.merge_tile(v, ci, re_, x, tr, tn, 1024, run_tiles=0)


def test_plain_route_and_short_operands_refused_on_the_card(card):
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(20)).astype(np.float32)
    v, re_, ci = csr.to_device(dtype=torch.float32, device=card)
    x = torch.ones(csr.num_cols, device=card)
    with pytest.raises(ValueError, match="does not run"):
        make_plan(csr.num_rows, csr.num_cols, csr.num_nonzeros,
                  backend="torch", device=card)
    plan = make_plan(csr.num_rows, csr.num_cols, csr.num_nonzeros,
                     device="cpu")
    with pytest.raises(ValueError, match="CPU tensors only"):
        csrmv(plan, v, re_, ci, x)
    op = build_operator(csr)
    K.reset_launches()
    with pytest.raises(ValueError, match="x must have shape"):
        op(x[:-1])
    tr, tn = merge_tile_coordinates(re_, csr.num_nonzeros, 256)
    with pytest.raises(ValueError, match="another tile size"):
        K.merge_tile(v, ci, re_, x, tr, tn, 1024)
    assert K.LAUNCHES == {"merge_tile": 0, "merge_tile_fused": 0,
                          "carry_fixup": 0, "merge_tile_mm": 0}


# ---------------------------------------------------------------------- #
# K3: the DIA kernel (csrc/dia_matvec.cu)
# ---------------------------------------------------------------------- #

def _dia_case(name):
    rs = np.random.RandomState(5)
    if name == "grid3d":
        coo = CooMatrix.grid3d(14)
    elif name == "rectangular":
        m, n = 300, 400
        coo = CooMatrix(m, n, np.r_[np.arange(m), np.arange(m)],
                        np.r_[np.arange(m), np.arange(m) + 50],
                        np.ones(2 * m))
    elif name == "wide_band":
        # 40 diagonals, more than the TPU kernel's 16
        n, offs = 3000, np.arange(-20, 20)
        r = np.repeat(np.arange(n), offs.size)
        c = r + np.tile(offs, n)
        keep = (c >= 0) & (c < n)
        coo = CooMatrix(n, n, r[keep], c[keep], np.ones(int(keep.sum())))
    else:   # mixed: a stencil plus scattered entries
        base = CooMatrix.grid2d(40)
        coo = CooMatrix(1600, 1600,
                        np.r_[base.rows, rs.randint(0, 1600, 300)],
                        np.r_[base.cols, rs.randint(0, 1600, 300)],
                        np.r_[base.vals, rs.uniform(-1, 1, 300)])
    csr = CsrMatrix.from_coo(coo).astype(np.float32)
    csr.values = rs.uniform(-1, 1, csr.num_nonzeros).astype(np.float32)
    return csr, rs


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["grid3d", "rectangular", "wide_band",
                                  "mixed"])
def test_dia_kernel_vs_plain_and_gold(card, name, dtype):
    csr, rs = _dia_case(name)
    if dtype == "float64":
        csr = csr.astype(np.float64)
    op = build_dia_operator(csr, dtype=dtype, max_diags=64)
    x = rs.uniform(-1, 1, csr.num_cols).astype(csr.values.dtype)
    y0 = rs.uniform(-1, 1, csr.num_rows).astype(csr.values.dtype)
    xd = torch.from_numpy(x).to(card)
    got = D.dia_matvec(op.vtab, xd, op.offsets_t, op.num_rows, op.num_cols,
                       1.5)
    plain = D.dia_matvec_plain(op.vtab, xd, op.offsets_t, op.num_rows,
                               op.num_cols, 1.5)
    torch.cuda.synchronize()
    if dtype == "float64":
        torch.testing.assert_close(got, plain, rtol=1e-12, atol=0)
    else:
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
    y = op(xd, y_in=torch.from_numpy(y0).to(card), alpha=2.0, beta=-0.5)
    bound = csr.spmv_abs_bound(x, y0, 2.0, -0.5)
    assert compare_results(y.cpu().numpy(),
                           csr.spmv_gold(x, y0, 2.0, -0.5), verbose=False,
                           abs_bound=bound) is None


def test_dia_kernel_repeat_calls_bitwise_equal(card):
    csr, rs = _dia_case("grid3d")
    op = build_dia_operator(csr)
    xd = torch.from_numpy(rs.uniform(-1, 1, csr.num_cols).astype(
        np.float32)).to(card)
    a = D.dia_matvec(op.vtab, xd, op.offsets_t, op.num_rows, op.num_cols)
    b = D.dia_matvec(op.vtab, xd, op.offsets_t, op.num_rows, op.num_cols)
    assert torch.equal(a, b)


def test_dia_operator_counts_launches(card):
    csr, rs = _dia_case("mixed")
    op = build_dia_operator(csr)
    D.reset_launches()
    K.reset_launches()
    op(torch.ones(csr.num_cols, device=card))
    op.mm(torch.ones(csr.num_cols, 2, device=card))
    torch.cuda.synchronize()
    # op(x): K3 and the leftover's K1; op.mm: K3m and the leftover's K1m
    assert D.LAUNCHES == {"dia_matvec": 1, "dia_matmat": 1}
    assert K.LAUNCHES == {"merge_tile": 0, "merge_tile_fused": 1,
                          "carry_fixup": 0, "merge_tile_mm": 1}


def test_dia_operator_bfloat16(card):
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(30))
    op = build_dia_operator(csr, dtype="bfloat16")
    y = op(torch.ones(csr.num_cols, dtype=torch.bfloat16, device=card))
    assert y.dtype == torch.bfloat16
    gold = csr.astype(np.float32).spmv_gold(np.ones(csr.num_cols,
                                                    np.float32))
    assert np.max(np.abs(y.float().cpu().numpy() - gold)) == 0.0


def test_dia_wrapper_rejects_what_the_kernel_does_not_take(card):
    csr, _ = _dia_case("grid3d")
    op = build_dia_operator(csr)
    x = torch.ones(csr.num_cols, device=card)
    args = (op.offsets_t, op.num_rows, op.num_cols)
    D.reset_launches()
    with pytest.raises(TypeError):
        D.dia_matvec(op.vtab.double(), x, *args)
    with pytest.raises(TypeError):
        D.dia_matvec(op.vtab, x, op.offsets_t.int(), op.num_rows,
                     op.num_cols)
    with pytest.raises(ValueError):
        D.dia_matvec(op.vtab, x[:-1], *args)
    with pytest.raises(ValueError):
        D.dia_matvec(op.vtab[:, ::2], x, *args)
    with pytest.raises(ValueError):
        D.dia_matvec(op.vtab, x.cpu(), *args)
    X = torch.ones(csr.num_cols, 4, device=card)
    with pytest.raises(TypeError):
        D.dia_matmat(op.vtab.double(), X, *args)
    with pytest.raises(ValueError):
        D.dia_matmat(op.vtab, X[:-1], *args)
    with pytest.raises(ValueError):
        D.dia_matmat(op.vtab, X, *args, Y_in=X[:2])
    assert D.LAUNCHES == {"dia_matvec": 0, "dia_matmat": 0}


# ---------------------------------------------------------------------- #
# P1: the op-class probe (csrc/sm_ceiling.cu)
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("grid", [5, 131])
@pytest.mark.parametrize("chains", [1, 8])
@pytest.mark.parametrize("cls", P.CLASSES)
def test_probe_kernel_vs_plain(card, cls, chains, grid):
    """Every class at small size (grid 131 takes the gather
    through every step modulo 128)."""
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (8, 128)).astype(np.float32)).to(card)
    got = P.probe(cls, x, grid, 8, chains, 64)    # checks the blocks agree
    want = P.probe_plain(cls, x, grid, 8, chains, 64)
    # fma: the kernel's FFMA rounds once where the plain version rounds
    # twice; every other class takes the same float32 operations
    if cls == "fma":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, want)


# ------------------------------------------------------- split operators

def _split_matrix(n=6000, deg=7, spread=900, seed=11):
    """The scattered-column fixture of tests/test_split.py."""
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rs.laplace(0.0, spread, rows.size).astype(np.int64),
                   0, n - 1)
    return CsrMatrix.from_coo(CooMatrix(n, n, rows, cols, rs.uniform(
        -1, 1, rows.size))).astype(np.float32)


def _hub_matrix(n=20000, deg=8, hubs=40, seed=7):
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    hub = rs.choice(n, hubs, replace=False)
    cols = np.where(rs.random(rows.size) < 0.6,
                    hub[rs.randint(0, hubs, rows.size)],
                    rs.randint(0, n, rows.size))
    return CsrMatrix.from_coo(CooMatrix(n, n, rows, cols, rs.uniform(
        -1, 1, rows.size))).astype(np.float32)


def _split_ops(kind, dev):
    from merge_spmv_tpu_torch.ops import split as S
    if kind == "hotcold":
        csr = _hub_matrix()
        return csr, S.build_hotcold_operator(csr, device=dev), 2
    csr = _split_matrix()
    if kind == "device":
        return csr, S.build_split_operator_device(csr, num_bands=4,
                                                  device=dev), 1
    return csr, S.build_split_operator(
        csr, edges_chunks="quantile", num_bands=4,
        compact_rows=kind == "compact", device=dev), 1


@pytest.mark.parametrize("kind", ["full", "compact", "device", "hotcold"])
def test_split_operators_on_the_card(card, kind):
    """op(x), op(x, y_in, alpha, beta) and op.mm on the card against the
    same operator on the CPU (the plain versions) and gold, with the
    launches each op(x) makes: one fused merge launch for a split, two
    for hot/cold."""
    csr, op, per_call = _split_ops(kind, card)
    _, cpu_op, _ = _split_ops(kind, "cpu")
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, csr.num_cols).astype(np.float32)
    y0 = rs.uniform(-1, 1, csr.num_rows).astype(np.float32)
    X = rs.uniform(-1, 1, (csr.num_cols, 3)).astype(np.float32)
    K.reset_launches()
    y = op(torch.from_numpy(x).to(card))
    y_ab = op(torch.from_numpy(x).to(card), y_in=torch.from_numpy(y0).to(
        card), alpha=1.5, beta=-0.5)
    Y = op.mm(torch.from_numpy(X).to(card))
    torch.cuda.synchronize()
    # op.mm: one K1m launch per merge operator inside, for all columns
    assert K.LAUNCHES["merge_tile_fused"] == per_call * 2
    assert K.LAUNCHES["merge_tile_mm"] == per_call
    assert K.LAUNCHES["merge_tile"] == K.LAUNCHES["carry_fixup"] == 0
    cases = [(y, cpu_op(torch.from_numpy(x)), csr.spmv_gold(x),
              csr.spmv_abs_bound(x)),
             (y_ab, cpu_op(torch.from_numpy(x), y_in=torch.from_numpy(y0),
                           alpha=1.5, beta=-0.5),
              csr.spmv_gold(x, y0, 1.5, -0.5),
              csr.spmv_abs_bound(x, y0, 1.5, -0.5))]
    cpu_Y = cpu_op.mm(torch.from_numpy(X))
    cases += [(Y[:, k], cpu_Y[:, k], csr.spmv_gold(X[:, k]),
               csr.spmv_abs_bound(X[:, k])) for k in range(X.shape[1])]
    for got, plain, gold, bound in cases:
        got = got.cpu().numpy()
        assert compare_results(got, gold, verbose=False,
                               abs_bound=bound) is None
        assert compare_results(got, plain.numpy(), verbose=False,
                               abs_bound=bound) is None


@pytest.mark.parametrize("kind", ["full", "compact", "device", "hotcold"])
def test_split_graph_replays_then_eager_call_bitwise_equal(card, kind):
    """Each operator's op(x) captured in a CUDA graph (no synchronisation,
    no counter allocated under capture) and replayed 20 times, then an
    eager call: every result has the eager call's bits."""
    csr, op, _ = _split_ops(kind, card)
    x = torch.from_numpy(np.random.RandomState(10).uniform(
        -1, 1, csr.num_cols).astype(np.float32)).to(card)
    eager = op(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(x)
    replays = []
    for _ in range(20):
        graph.replay()
        replays.append(captured.clone())
    after = op(x)
    torch.cuda.synchronize()
    assert all(torch.equal(r, eager) for r in replays)
    assert torch.equal(after, eager)


def test_device_split_builder_on_the_card_matches_the_cpu(card):
    """build_split_operator_device on the card gives the CPU run's edges
    (band count and band nnz), m_pad and stacked arrays."""
    from merge_spmv_tpu_torch.ops import split as S
    csr = _split_matrix(n=20000, deg=9, spread=3000, seed=5)
    on_card = S.build_split_operator_device(csr, num_bands=16, device=card)
    on_cpu = S.build_split_operator_device(csr, num_bands=16, device="cpu")
    assert on_card.num_bands == on_cpu.num_bands > 2
    assert on_card.band_nnz == on_cpu.band_nnz
    assert on_card._m_pad == on_cpu._m_pad
    assert on_card.plan == dataclasses.replace(on_cpu.plan, backend="cuda")
    for name in ("values", "row_end_offsets", "col_indices"):
        assert torch.equal(getattr(on_card.op, name).cpu(),
                           getattr(on_cpu.op, name)), name
    assert on_card.abs_row_sum_max == pytest.approx(on_cpu.abs_row_sum_max,
                                                    rel=1e-12)


def test_autotune_times_once_then_reads_the_cache(card, tmp_path,
                                                  monkeypatch):
    """The tuner times each candidate once per shape class on the card,
    stores the fastest, and a second build reads it and times nothing."""
    from merge_spmv_tpu_torch.ops import autotune as A
    monkeypatch.setenv(A.CACHE_ENV, str(tmp_path / "tune.json"))
    csr = CsrMatrix.from_coo(CooMatrix.grid3d(30)).astype(np.float32)
    A.reset_timed()
    op = build_operator(csr, autotune=True)
    assert A.TIMED["candidates"] == len(A.DEFAULT_CANDIDATES)
    assert op.plan.tile_items in A.DEFAULT_CANDIDATES
    A.reset_timed()
    again = build_operator(csr, autotune=True)
    assert A.TIMED["candidates"] == 0
    assert again.plan.tile_items == op.plan.tile_items
    x = np.ones(csr.num_cols, np.float32)
    assert compare_results(again(torch.from_numpy(x).to(card)).cpu().numpy(),
                           csr.spmv_gold(x), verbose=False,
                           abs_bound=csr.spmv_abs_bound(x)) is None


# ------------------------------------------------------- gather-rate probe

@pytest.mark.parametrize("blocks", [1, 3, None])
@pytest.mark.parametrize("count", [0, 5_000, 1_000_003])
def test_gather_rate_kernel_vs_plain(card, count, blocks):
    """The probe kernel sums each thread's reads in the plain version's
    order: the same bits, with the launch counted."""
    from merge_spmv_tpu_torch.tools import gather_rate as GR
    rs = np.random.RandomState(count)
    x = torch.from_numpy(rs.uniform(-1, 1, 100_000).astype(
        np.float32)).to(card)
    idx = torch.from_numpy(rs.randint(0, 100_000, count).astype(
        np.int32)).to(card)
    GR.reset_launches()
    got = GR.gather_sum(x, idx, blocks)
    want = GR.gather_sum_plain(x, idx, got.shape[0])
    torch.cuda.synchronize()
    assert GR.LAUNCHES == {"gather_rate": 1, "gather_rows": 0}
    assert torch.equal(got, want)


@pytest.mark.parametrize("blocks", [1, 3, None])
@pytest.mark.parametrize("row_floats", [4, 8, 32, 64])
@pytest.mark.parametrize("count", [0, 5_000, 1_000_003])
def test_gather_rows_kernel_vs_plain(card, count, row_floats, blocks):
    """The rows class sums each lane's four floats in the plain version's
    order: the same bits, with the launch counted."""
    from merge_spmv_tpu_torch.tools import gather_rate as GR
    rs = np.random.RandomState(count + row_floats)
    X = torch.from_numpy(rs.uniform(-1, 1, (10_000, row_floats)).astype(
        np.float32)).to(card)
    idx = torch.from_numpy(rs.randint(0, 10_000, count).astype(
        np.int32)).to(card)
    GR.reset_launches()
    got = GR.gather_rows(X, idx, blocks)
    want = GR.gather_rows_plain(X, idx, got.shape[0] // 4)
    torch.cuda.synchronize()
    assert GR.LAUNCHES == {"gather_rate": 0, "gather_rows": 1}
    assert torch.equal(got, want)


# ------------------------------------------------------------ solvers

def _laplacian(width):
    """L = D - A + I of the width x width grid (tests/test_solvers.py:17),
    built without densifying."""
    coo = CooMatrix.grid2d(width)
    n = coo.num_rows
    deg = np.bincount(coo.rows, minlength=n).astype(np.float64)
    rows = np.r_[coo.rows, np.arange(n)]
    cols = np.r_[coo.cols, np.arange(n)]
    vals = np.r_[-np.ones(coo.rows.size), deg + 1.0]
    return CsrMatrix.from_coo(CooMatrix(n, n, rows, cols, vals)).astype(
        np.float32)


def _ring_pagerank(n):
    """Column-stochastic P of a banded link graph (i -> i+1, i-1, i+3):
    its diagonals take the DIA operator."""
    src = np.r_[np.arange(n - 1), np.arange(1, n), np.arange(n - 3)]
    dst = np.r_[np.arange(1, n), np.arange(n - 1), np.arange(3, n)]
    out_deg = np.bincount(src, minlength=n).astype(np.float64)
    return CsrMatrix.from_coo(CooMatrix(n, n, dst, src,
                                        1.0 / out_deg[src])).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["merge", "dia"])
def test_solvers_graph_replay_equals_eager_loop(card, kind):
    """CG and PageRank on the card: replaying the captured block of
    masked iterations gives the bits of the uncaptured loop, whatever
    the block size, and the answers hold against NumPy."""
    from merge_spmv_tpu_torch.models.solvers import (conjugate_gradient,
                                                     pagerank)
    build = build_operator if kind == "merge" else build_dia_operator
    lap = _laplacian(30)
    op = build(lap)
    if kind == "dia":
        assert op.rest_op is None and op.offsets.size == 5
    b = np.random.RandomState(0).uniform(-1, 1, lap.num_rows).astype(
        np.float32)
    runs = [conjugate_gradient(op, b, tol=1e-6, maxiter=500, check_every=c,
                               graph=g)
            for c, g in ((4, False), (4, True), (16, True), (1, True))]
    x0, i0 = runs[0]
    for x, info in runs[1:]:
        assert int(info.iterations) == int(i0.iterations) > 4
        assert torch.equal(x, x0) and torch.equal(info.residual, i0.residual)
    assert i0.step_ms is None and runs[1][1].step_ms > 0
    dense = np.zeros((lap.num_rows,) * 2)
    np.add.at(dense, (lap.row_ids(), lap.col_indices), lap.values)
    want = np.linalg.solve(dense, b.astype(np.float64))
    np.testing.assert_allclose(x0.cpu().numpy(), want, rtol=2e-3, atol=2e-3)

    P = _ring_pagerank(3000)
    op_p = build(P)
    if kind == "dia":
        assert op_p.rest_op is None
    runs = [pagerank(op_p, tol=1e-7, maxiter=300, check_every=c, graph=g)
            for c, g in ((8, False), (8, True), (32, True))]
    pr0, i0 = runs[0]
    for pr, info in runs[1:]:
        assert int(info.iterations) == int(i0.iterations)
        assert torch.equal(pr, pr0)
    assert abs(float(pr0.double().sum()) - 1.0) < 1e-4


def test_solver_launches_and_reads(card):
    """One K1 launch per CG iteration and per eager block of the loop;
    the host reads the flag once per block."""
    from merge_spmv_tpu_torch.models.solvers import conjugate_gradient
    lap = _laplacian(20)
    op = build_operator(lap)
    b = np.ones(lap.num_rows, np.float32)
    K.reset_launches()
    _, info = conjugate_gradient(op, b, tol=1e-6, maxiter=500, check_every=5,
                                 graph=False)
    torch.cuda.synchronize()
    it = int(info.iterations)
    assert info.host_reads == -(-it // 5)
    assert K.LAUNCHES["merge_tile_fused"] == 1 + 5 * info.host_reads


# ------------------------------------------------------------ multi-process

def test_two_process_gloo_worker_on_the_card(card):
    """Two ranks of merge_spmv_tpu_torch.parallel.mp_worker on cuda:0 with
    gloo (the exchanges staged through the host): both verify their
    windows and print PASS."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "merge_spmv_tpu_torch.parallel.mp_worker",
         str(r), "2", str(port), "--device", "cuda"], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"PASS rank={r} world=2 device=cuda" in out, out


# ------------------------------------------------------------ north-star configs

def test_cant_class_float64_against_gold_and_cusparse(card):
    """cant_class at its published size (62,451 rows, 3,996,864 nonzeros,
    float64; tools/bench_baseline_configs.py) through op(x), one K1
    launch: against the gold SpMV (backward-error bound) and against
    cuSPARSE's float64 product.  Two float64 sums of a row's 64 terms in
    any orders each lie within gamma_64 |A| |x| of the exact sum, so they
    differ by at most 2 gamma_64 |A| |x| per row."""
    from merge_spmv_tpu_torch.bench.measure import library_csr
    from merge_spmv_tpu_torch.tools import bench_baseline_configs as BC

    csr = BC.cant_csr(np.float64)
    assert (csr.num_rows, csr.num_nonzeros) == (62451, 3_996_864)
    x = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols)
    op = build_operator(csr, dtype="float64", device=card)
    xd = torch.from_numpy(x).to(card)
    K.reset_launches()
    y = op(xd)
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_tile_fused"] == 1
    assert y.dtype == torch.float64
    abs_bound = csr.spmv_abs_bound(x, segmented_block=0)
    assert compare_results(y.cpu().numpy(), csr.spmv_gold(x), verbose=False,
                           abs_bound=csr.spmv_abs_bound(x)) is None
    lib = torch.mv(library_csr(op), xd).cpu().numpy()
    n = 64
    gamma = n * 2.0 ** -53 / (1 - n * 2.0 ** -53)
    assert np.all(np.abs(y.cpu().numpy() - lib) <= 2 * gamma * abs_bound)


def test_spmm_pdb1hys_k8_against_gold_and_cusparse(card):
    """pdb1HYS class (36,417 rows, 4,333,623 nonzeros, float32) times a
    row-major X of 8 columns through op.mm, one K1m launch:
    against spmm_gold and cuSPARSE SpMM (torch.sparse.mm), each within
    the JAX tool's 1e-4 of max |Y| (tools/bench_baseline_configs.py:
    369-372)."""
    from merge_spmv_tpu_torch.bench.measure import library_csr
    from merge_spmv_tpu_torch.tools import bench_baseline_configs as BC

    csr = BC.pdb1hys_csr()
    assert (csr.num_rows, csr.num_nonzeros) == (36417, 4_333_623)
    X = np.random.RandomState(2).uniform(-1, 1, (csr.num_cols, 8)
                                         ).astype(np.float32)
    op = build_operator(csr, dtype="float32", device=card)
    Xd = torch.from_numpy(X).to(card)
    K.reset_launches()
    Y = op.mm(Xd)
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_tile_mm"] == 1
    assert K.LAUNCHES["merge_tile_fused"] == 0
    gold = csr.spmm_gold(X)
    scale = float(np.abs(gold).max())
    assert float(np.abs(Y.cpu().numpy() - gold).max()) < 1e-4 * scale
    lib = torch.sparse.mm(library_csr(op), Xd).cpu().numpy()
    assert float(np.abs(Y.cpu().numpy() - lib).max()) < 1e-4 * scale


# ---------------------------------------------------------------------- #
# K1m and K3m: SpMM in one launch (csrc/merge_csrmm.cu, dia_matmat)
# ---------------------------------------------------------------------- #

MM_CASES = ("wheel_hub_spans_tiles", "powerlaw", "empty_rows", "nnz0",
            "dense_rows", "multi_chunk_cols", "one_col")
MM_K = (2, 3, 8, 32, 33, 64)


def _mm_setup(name, dev, k, dtype, tile_items=256, seed=0,
              col_major=False):
    """A CASES matrix with signed values, X [n, k] and Y_in [m, k] on
    ``dev``; X column-major when asked."""
    csr = CsrMatrix.from_coo(CASES[name]())
    rs = np.random.RandomState(seed)
    csr.values = rs.uniform(-1, 1, csr.num_nonzeros)
    X = rs.uniform(-1, 1, (csr.num_cols, k))
    Y_in = rs.uniform(-1, 1, (csr.num_rows, k))
    v, re_, ci = csr.to_device(dtype=dtype, device=dev)
    tiles = merge_tile_coordinates(re_, csr.num_nonzeros, tile_items)
    Xd = torch.from_numpy(X).to(dev, dtype)
    if col_major:
        Xd = Xd.t().contiguous().t()
    return csr, (v, ci, re_), Xd, torch.from_numpy(Y_in).to(dev, dtype), \
        tiles, X, Y_in


def _assert_columns(got, want, csr, X, Y_in, alpha, beta, what):
    for j in range(X.shape[1]):
        bound = csr.spmv_abs_bound(X[:, j], Y_in[:, j], alpha, beta)
        assert compare_results(got[:, j], want[:, j], verbose=False,
                               abs_bound=bound) is None, f"{what}[:, {j}]"


@pytest.mark.parametrize("col_major", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", MM_K)
@pytest.mark.parametrize("name", MM_CASES)
def test_k1m_vs_plain_and_gold(card, name, k, dtype, col_major):
    """K1m against its plain version at the same runs and against gold,
    column by column within spmv_abs_bound, X row- or column-major (one
    counted copy), one launch for k up to 64."""
    csr, arrs, Xd, Yd, tiles, X, Y_in = _mm_setup(
        name, card, k, dtype, col_major=col_major)
    K.reset_launches()
    Y = K.merge_csrmm(*arrs, Xd, *tiles, 256, Yd, 1.5, -0.5)
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_tile_mm"] == 1
    assert K.COPIES["x_row_major"] == int(not Xd.is_contiguous())
    geo = K.mm_launch_geometry(tiles[0].shape[0] - 1, 256, dtype, card, k)
    plain = K.merge_csrmm_plain(*arrs, Xd, *tiles, 256, Yd, 1.5, -0.5,
                                run_tiles=geo.run_tiles)
    assert Y.shape == (csr.num_rows, k) and Y.dtype == dtype
    gold = np.stack([csr.spmv_gold(X[:, j], Y_in[:, j], 1.5, -0.5)
                     for j in range(k)], 1)
    got = Y.cpu().numpy()
    _assert_columns(got, plain.cpu().numpy(), csr, X, Y_in, 1.5, -0.5,
                    "plain")
    _assert_columns(got, gold, csr, X, Y_in, 1.5, -0.5, "gold")


@pytest.mark.parametrize("k", [65, 130])
def test_k1m_cuts_wide_k_into_column_blocks(card, k):
    """k above 64: column blocks of 64, a launch each, each reading A
    once; the result is the plain version's."""
    csr, arrs, Xd, Yd, tiles, X, Y_in = _mm_setup("powerlaw", card, k,
                                                  torch.float32)
    K.reset_launches()
    Y = K.merge_csrmm(*arrs, Xd, *tiles, 256, Yd, 1.5, -0.5)
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_tile_mm"] == -(-k // 64)
    gold = np.stack([csr.spmv_gold(X[:, j], Y_in[:, j], 1.5, -0.5)
                     for j in range(k)], 1)
    _assert_columns(Y.cpu().numpy(), gold, csr, X, Y_in, 1.5, -0.5, "gold")


@pytest.mark.parametrize("k", MM_K)
def test_operator_mm_is_one_k1m_launch(card, k):
    """op.mm with method="auto": one K1m launch for all k columns and no
    K1 launch; method="column": k K1 launches; both agree with gold."""
    csr = _big("hub").astype(np.float32)
    op = build_operator(csr)
    rs = np.random.RandomState(k)
    X = rs.uniform(-1, 1, (csr.num_cols, k)).astype(np.float32)
    Xd = torch.from_numpy(X).to(card)
    K.reset_launches()
    Y = op.mm(Xd)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"merge_tile": 0, "merge_tile_fused": 0,
                          "carry_fixup": 0, "merge_tile_mm": 1}
    Yc = op.mm(Xd, method="column")
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_tile_fused"] == k
    for j in range(k):
        gold = csr.spmv_gold(X[:, j])
        bound = csr.spmv_abs_bound(X[:, j])
        for got in (Y, Yc):
            assert compare_results(got[:, j].cpu().numpy(), gold,
                                   verbose=False, abs_bound=bound) is None


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1m_repeat_calls_and_graph_replays_bitwise_equal(card, dtype):
    """Two eager op.mm calls, then 20 replays of a captured one, then an
    eager call: the same bits every time (the carries are joined in run
    order; the ticket counter is left at 0, shared with op(x))."""
    csr = CsrMatrix.from_coo(CooMatrix.wheel(20_000))
    csr.values = np.random.RandomState(9).uniform(-1, 1, csr.num_nonzeros)
    op = build_operator(csr, dtype=dtype, tile_items=256)
    X = torch.from_numpy(np.random.RandomState(10).uniform(
        -1, 1, (csr.num_cols, 32))).to(card, op.values.dtype)
    eager = op.mm(X)
    assert torch.equal(eager, op.mm(X))
    y = op(X[:, 0].contiguous())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op.mm(X)
    replays = []
    for _ in range(20):
        graph.replay()
        replays.append(captured.clone())
    after = op.mm(X)
    torch.cuda.synchronize()
    assert all(torch.equal(r, eager) for r in replays)
    assert torch.equal(after, eager)
    assert torch.equal(op(X[:, 0].contiguous()), y)


def test_k1m_indexing_past_int32(card):
    """row * k and col * ldx past 2^31: 2^26 + 2^20 rows and columns, one
    nonzero a row at a scattered column, k = 32 in float32 (X and Y 8.7 GB
    each): every Y row is its one product, compared exactly."""
    m = (1 << 26) + (1 << 20)
    k = 32
    assert (m - 1) * k >= 2**31
    rows = torch.arange(m, device=card, dtype=torch.int64)
    cols = ((rows * 7919 + 13) % m).to(torch.int32)
    row_end = (rows + 1).to(torch.int32)
    values = torch.rand(m, device=card) + 0.5
    X = torch.rand(m, k, device=card)
    tiles = merge_tile_coordinates(row_end, m, 2048)
    Y = K.merge_csrmm(values, cols, row_end, X, *tiles, 2048)
    torch.cuda.synchronize()
    want = values[:, None] * X[cols.long()]
    assert torch.equal(Y, want)


def test_k1m_wrapper_rejects_what_the_kernel_does_not_take(card):
    _, arrs, Xd, Yd, tiles, _, _ = _mm_setup("powerlaw", card, 8,
                                             torch.float32)
    with pytest.raises(TypeError):
        K.merge_csrmm(*arrs, Xd.double(), *tiles, 256)
    with pytest.raises(ValueError, match="Y_in"):
        K.merge_csrmm(*arrs, Xd, *tiles, 256, Yd[:, :4])
    with pytest.raises(ValueError, match="another tile size"):
        K.merge_csrmm(*arrs, Xd, *tiles, 1024)
    with pytest.raises(ValueError, match="several devices"):
        K.merge_csrmm(*arrs, Xd.cpu(), *tiles, 256)


@pytest.mark.parametrize("col_major", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", MM_K)
@pytest.mark.parametrize("name", ["grid3d", "rectangular", "wide_band",
                                  "mixed"])
def test_k3m_vs_plain_and_gold(card, name, k, dtype, col_major):
    """K3m against its plain version (the JAX package's shifted
    multiply-add) and the DIA operator's op.mm against gold, column by
    column within spmv_abs_bound; one K3m launch."""
    csr, rs = _dia_case(name)
    if dtype == "float64":
        csr = csr.astype(np.float64)
    op = build_dia_operator(csr, dtype=dtype, max_diags=64)
    X = rs.uniform(-1, 1, (csr.num_cols, k)).astype(csr.values.dtype)
    Y0 = rs.uniform(-1, 1, (csr.num_rows, k)).astype(csr.values.dtype)
    Xd = torch.from_numpy(X).to(card)
    if col_major:
        Xd = Xd.t().contiguous().t()
    Yd = torch.from_numpy(Y0).to(card)
    D.reset_launches()
    got = D.dia_matmat(op.vtab, Xd, op.offsets_t, op.num_rows, op.num_cols,
                       1.5, Yd, -0.5)
    torch.cuda.synchronize()
    assert D.LAUNCHES == {"dia_matvec": 0, "dia_matmat": 1}
    plain = D.dia_matmat_plain(op.vtab, Xd, op.offsets_t, op.num_rows,
                               op.num_cols, 1.5, Yd, -0.5)
    if dtype == "float64":
        torch.testing.assert_close(got, plain, rtol=1e-12, atol=1e-12)
    else:
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
    Y = op.mm(Xd, Y_in=Yd, alpha=2.0, beta=-0.5).cpu().numpy()
    gold = np.stack([csr.spmv_gold(X[:, j], Y0[:, j], 2.0, -0.5)
                     for j in range(k)], 1)
    _assert_columns(Y, gold, csr, X, Y0, 2.0, -0.5, "gold")


def test_dia_mm_one_k3m_launch_repeat_and_graph_bitwise_equal(card):
    """DiaSpmvOperator.mm: one K3m launch (beta * Y_in fused, no
    leftover), bitwise equal on a repeat and on graph replays;
    method="column" runs K3 once per column."""
    csr, rs = _dia_case("grid3d")
    op = build_dia_operator(csr)
    assert op.rest_op is None
    X = torch.from_numpy(rs.uniform(-1, 1, (csr.num_cols, 32)).astype(
        np.float32)).to(card)
    Y0 = torch.ones(csr.num_rows, 32, device=card)
    D.reset_launches()
    K.reset_launches()
    eager = op.mm(X, Y_in=Y0, alpha=2.0, beta=0.5)
    torch.cuda.synchronize()
    assert D.LAUNCHES == {"dia_matvec": 0, "dia_matmat": 1}
    assert not any(K.LAUNCHES.values())
    assert torch.equal(eager, op.mm(X, Y_in=Y0, alpha=2.0, beta=0.5))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op.mm(X, Y_in=Y0, alpha=2.0, beta=0.5)
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    column = op.mm(X, Y_in=Y0, alpha=2.0, beta=0.5, method="column")
    torch.cuda.synchronize()
    assert D.LAUNCHES["dia_matvec"] == 32
    torch.testing.assert_close(column, eager, rtol=1e-5, atol=1e-5)
