"""The port's merge-path search and plan held against the JAX package's:
split coordinates are exactly equal integers, the byte and flop models
agree, and the Hopper tile policy multiplies out to the tile."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import merge_spmv_tpu.ops.merge_path as jmp
import merge_spmv_tpu.ops.plan as jplan
import merge_spmv_tpu_torch.ops.merge_path as tmp
import merge_spmv_tpu_torch.ops.plan as tplan
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix

SEARCH_CASES = [
    ([1, 2, 3, 4], 4),                 # uniform
    ([0, 0, 0, 5], 5),                 # leading empty rows
    ([5, 5, 5, 5], 5),                 # trailing empty rows
    ([2, 2, 2, 9, 9, 9, 10], 10),      # mixed empties
    ([100], 100),                      # single huge row
    ([0], 0),                          # empty matrix
    (list(range(1, 51)), 50),          # 1 nnz per row
]


@pytest.mark.parametrize("a,nnz", SEARCH_CASES)
def test_search_matches_jax_every_diagonal(a, nnz):
    a = np.asarray(a, dtype=np.int32)
    diags = np.arange(len(a) + nnz + 1)
    jx, jy = jmp.merge_path_search(jnp.asarray(diags), jnp.asarray(a), nnz)
    tx, ty = tmp.merge_path_search(torch.from_numpy(diags),
                                   torch.from_numpy(a), nnz)
    assert tx.dtype == torch.int32 and ty.dtype == torch.int32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    hx, hy = tmp.merge_path_search_np(diags, a, nnz)
    np.testing.assert_array_equal(tx.numpy(), hx)
    np.testing.assert_array_equal(ty.numpy(), hy)


TILE_CASES = {
    "grid2d": (lambda: CooMatrix.grid2d(20), 256),
    "wheel": (lambda: CooMatrix.wheel(1000), 128),
    "powerlaw": (lambda: CooMatrix.random_powerlaw(512, 64, 4096, seed=0),
                 64),
    "empty_rows": (lambda: CooMatrix(900, 64, rows=[5, 5, 850],
                                     cols=[0, 63, 3], vals=[1., 2., 3.]),
                   256),
    "nnz0": (lambda: CooMatrix(300, 5, rows=[], cols=[], vals=[]), 256),
}


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_coordinates_match_jax(name):
    make, tile_items = TILE_CASES[name]
    csr = CsrMatrix.from_coo(make())
    a = csr.row_end_offsets
    jr, jn = jmp.merge_tile_coordinates(jnp.asarray(a), csr.num_nonzeros,
                                        tile_items)
    tr, tn = tmp.merge_tile_coordinates(torch.from_numpy(a),
                                        csr.num_nonzeros, tile_items)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    hr, hn = jmp.merge_tile_coordinates_np(a, csr.num_nonzeros, tile_items)
    pr, pn = tmp.merge_tile_coordinates_np(a, csr.num_nonzeros, tile_items)
    np.testing.assert_array_equal(pr, hr)
    np.testing.assert_array_equal(pn, hn)
    np.testing.assert_array_equal(tr.numpy(), pr)
    # equal work per tile, full consumption
    work = np.diff(pr) + np.diff(pn)
    assert (work[:-1] == tile_items).all() and work[-1] <= tile_items
    assert pr[-1] == csr.num_rows and pn[-1] == csr.num_nonzeros


@pytest.mark.parametrize("shape", [(1000, 1000, 5000), (3, 7, 0),
                                   (1_000_000, 1_000_000, 5_940_000)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("num_rhs", [1, 4])
def test_plan_models_match_jax(shape, dtype, num_rhs):
    j = jplan.make_plan(*shape, dtype=dtype, backend="xla", num_rhs=num_rhs)
    t = tplan.make_plan(*shape, dtype=dtype, num_rhs=num_rhs, device="cpu")
    assert t.flops() == j.flops()
    assert t.bytes_accessed() == j.bytes_accessed()
    assert (t.num_rows, t.num_cols, t.num_nonzeros, t.dtype, t.num_rhs) == \
        (j.num_rows, j.num_cols, j.num_nonzeros, j.dtype, j.num_rhs)


def test_grid3d100_byte_model():
    # the bound PERF.md quotes: 5.94M * 12 + 1M * 8 bytes
    p = tplan.make_plan(1_000_000, 1_000_000, 5_940_000, device="cpu")
    assert p.bytes_accessed() == 79_280_000
    assert p.flops() == 11_880_000


@pytest.mark.parametrize("tile_items,expect", [
    (None, 2048), (1000, 1024), (1024, 1024), (100, 256), (65536, 4096)])
def test_tile_policy(tile_items, expect):
    p = tplan.make_plan(50_000, 50_000, 300_000, tile_items=tile_items,
                        device="cpu")
    assert p.tile_items == expect
    assert p.threads_per_block * p.items_per_thread == p.tile_items
    assert p.threads_per_block % 32 == 0
    assert p.num_tiles == tmp.num_merge_tiles(50_000, 300_000, expect)


def test_small_matrix_shrinks_tile():
    p = tplan.make_plan(20, 20, 60, device="cpu")
    assert p.tile_items == tplan.MIN_TILE_ITEMS and p.num_tiles == 1


def test_backend_follows_device():
    assert tplan.make_plan(10, 10, 30, device="cpu").backend == "torch"
    assert tplan.make_plan(10, 10, 30, device="cuda").backend == "cuda"
    assert tplan.make_plan(10, 10, 30).backend == "cuda"
    with pytest.raises(ValueError):
        tplan.make_plan(10, 10, 30, backend="pallas")
    # a backend that disagrees with the device is refused
    with pytest.raises(ValueError, match="does not run"):
        tplan.make_plan(10, 10, 30, backend="torch")
    with pytest.raises(ValueError, match="does not run"):
        tplan.make_plan(10, 10, 30, backend="cuda", device="cpu")


def test_int32_merge_coordinates_guarded():
    with pytest.raises(ValueError, match="int32"):
        tplan.make_plan(2**30, 2**30, 2**30, device="cpu")


def test_bfloat16_plan():
    p = tplan.make_plan(100, 100, 500, dtype="bfloat16", device="cpu")
    assert p.dtype == "bfloat16"
    assert p.bytes_accessed() == 500 * (2 * 2 + 4) + 100 * (4 + 2)
