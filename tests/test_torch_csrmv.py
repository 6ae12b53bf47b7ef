"""The port's CsrMV held against the JAX package's on the same inputs.

* csrmv_torch (the "torch" backend and oracle) vs csrmv_xla;
* merge_csrmv_plain — the CUDA kernels' plain version, with the same
  tile / carry / fix-up decomposition — vs the Pallas kernel run in
  interpret mode on the cases tests/conftest.py keeps fast, and vs
  csrmv_xla on the rest;
* build_operator(..., device="cpu") vs the JAX operator path.

Every comparison is compare_results with the spmv_abs_bound backward-error
bound (the rule bench.py:74 applies), unless stated.  Inputs are made from
a seed with numpy and handed to both packages.
"""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
import merge_spmv_tpu.ops.csrmv_xla as jx
from merge_spmv_tpu.ops.csrmv_pallas import csrmv_pallas
from merge_spmv_tpu.ops.plan import make_plan as jmake_plan
import merge_spmv_tpu_torch.ops.csrmv_torch as tt
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops.csrmv import csrmm, csrmv, csrmv_fn
from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.plan import make_plan
from merge_spmv_tpu_torch.utils.compare import compare_results

# the JAX kernel tests' matrices (tests/test_csrmv_pallas.py:47-61)
CASES = {
    "grid2d_small": lambda: jcoo.CooMatrix.grid2d(6),
    "grid2d": lambda: jcoo.CooMatrix.grid2d(20),
    "wheel_single_tile": lambda: jcoo.CooMatrix.wheel(100),
    "wheel_hub_spans_tiles": lambda: jcoo.CooMatrix.wheel(3000),
    "empty_rows": lambda: jcoo.CooMatrix(900, 64, rows=[5, 5, 850],
                                         cols=[0, 63, 3], vals=[1., 2., 3.]),
    "leading_trailing_empty": lambda: jcoo.CooMatrix(
        2100, 32, rows=[1050], cols=[7], vals=[2.0]),
    "duplicates": lambda: jcoo.CooMatrix(4, 4, rows=[1, 1, 1],
                                         cols=[2, 2, 2], vals=[1., 2., 3.]),
    "powerlaw": lambda: jcoo.CooMatrix.random_powerlaw(800, 700, 6000,
                                                       seed=3),
    "dense_rows": lambda: jcoo.CooMatrix.dense(50, 60),
    "multi_chunk_cols": lambda: jcoo.CooMatrix.random_uniform(300, 6000, 8,
                                                              seed=9),
}
# run through the Pallas kernel in interpret mode (conftest keeps these fast)
INTERPRET_CASES = ("grid2d_small", "wheel_single_tile", "empty_rows",
                   "duplicates")


def _inputs(make, seed=0, signed=False, dtype=np.float32, y_in=False):
    """A JAX-package CSR and its port twin on identical arrays, plus x and
    y_in drawn from ``seed``."""
    j = jcsr.CsrMatrix.from_coo(make())
    rs = np.random.RandomState(seed)
    lo = -1.0 if signed else 0.1
    j.values = rs.uniform(lo, 1, j.num_nonzeros).astype(dtype)
    x = rs.uniform(lo, 1, j.num_cols).astype(dtype)
    yi = rs.uniform(lo, 1, j.num_rows).astype(dtype) if y_in else None
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    return j, t, x, yi


def _jax_reference(j, x, yi, alpha, beta, tile_items, interpret):
    v, re_, ci = j.to_device(dtype=np.float32)
    xj = jnp.asarray(x)
    yj = None if yi is None else jnp.asarray(yi)
    if interpret:
        plan = jmake_plan(j.num_rows, j.num_cols, j.num_nonzeros,
                          dtype=np.float32, tile_items=tile_items,
                          backend="pallas")
        y = csrmv_pallas(plan, v, re_, ci, xj, y_in=yj, alpha=alpha,
                         beta=beta, interpret=True)
    else:
        y = jx.csrmv_xla(v, re_, ci, xj, y_in=yj, alpha=alpha, beta=beta)
    return np.asarray(y)


def _assert_close(got, want, bound, context):
    idx = compare_results(got, want, verbose=False, abs_bound=bound)
    assert idx is None, (f"{context}: [{idx}] got {got.ravel()[idx]!r} "
                         f"want {want.ravel()[idx]!r}")


def _merge_plain(t, x, yi, alpha, beta, tile_items):
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    tr, tn = merge_tile_coordinates(re_, t.num_nonzeros, tile_items)
    return K.merge_csrmv_plain(
        v, ci, re_, torch.from_numpy(x), tr, tn, tile_items,
        None if yi is None else torch.from_numpy(yi), alpha, beta).numpy()


# ---------------------------------------------------------------------- #
# The merge decomposition (the kernels' plain version) vs the JAX package
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_plain_vs_jax(name):
    j, t, x, _ = _inputs(CASES[name])
    got = _merge_plain(t, x, None, 1.0, 0.0, 1024)
    want = _jax_reference(j, x, None, 1.0, 0.0, 1024,
                          interpret=name in INTERPRET_CASES)
    bound = j.spmv_abs_bound(x)
    _assert_close(got, want, bound, f"{name} vs jax")
    _assert_close(got, j.spmv_gold(x), bound, f"{name} vs gold")


@pytest.mark.parametrize("case", [
    # (name, tile_items, alpha, beta, y_in, signed)
    ("tile_boundary", 1024, 1.0, 0.0, False, False),
    ("powerlaw", 1024, 2.5, -0.75, True, False),
    ("wheel_hub_spans_tiles", 2048, 1.0, 0.0, False, False),
    ("powerlaw", 1024, 1.0, 0.0, False, True),
    ("wheel_hub_spans_tiles", 256, -1.5, 2.0, True, True),
], ids=["tile_boundary", "alpha_beta", "tile2048", "signed", "wheel256"])
def test_merge_plain_variants_vs_jax(case):
    name, tile_items, alpha, beta, with_y, signed = case
    make = (CASES[name] if name in CASES else
            lambda: jcoo.CooMatrix.random_uniform(256, 128, 8, seed=1))
    j, t, x, yi = _inputs(make, seed=5, signed=signed, y_in=with_y)
    got = _merge_plain(t, x, yi, alpha, beta, tile_items)
    want = _jax_reference(j, x, yi, alpha, beta, tile_items, interpret=False)
    bound = j.spmv_abs_bound(x, yi, alpha, beta)
    _assert_close(got, want, bound, f"{name} vs jax")
    _assert_close(got, j.spmv_gold(x, yi, alpha, beta), bound,
                  f"{name} vs gold")


def test_carries_follow_the_tile_split():
    """Tile t's carry pair is (tile_rows[t+1], the partial of that row in
    tile t); a tile ending exactly on a row end leaves exactly 0."""
    # 9 merge items per row: 2304-item tiles end exactly on every 256th row
    _, t, x, _ = _inputs(
        lambda: jcoo.CooMatrix.random_uniform(600, 128, 8, seed=1))
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    tr, tn = merge_tile_coordinates(re_, t.num_nonzeros, 2304)
    y, crow, cval = K.merge_tile_plain(v, ci, re_, torch.from_numpy(x),
                                       tr, tn, 2304)
    assert torch.equal(crow, tr[1:])
    # the tile's last item is the end of row tile_rows[t+1] - 1
    last = (tr[1:] - 1).clamp(min=0).long()
    ends_on_row = (tr[1:] > 0) & (re_[last] == tn[1:]) & (tr[1:] < t.num_rows)
    assert ends_on_row.any()
    assert (cval[ends_on_row] == 0).all()
    # the partial sums plus the carries give every row's full sum
    full = K.carry_fixup_plain(y.clone(), crow, cval, 1.0).numpy()
    _assert_close(full, t.spmv_gold(x), t.spmv_abs_bound(x), "fixup")


def test_hub_carry_spans_many_tiles():
    _, t, x, _ = _inputs(CASES["wheel_hub_spans_tiles"])
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    tr, tn = merge_tile_coordinates(re_, t.num_nonzeros, 256)
    _, crow, cval = K.merge_tile_plain(v, ci, re_, torch.from_numpy(x),
                                       tr, tn, 256)
    assert int((crow == 0).sum()) > 2 and bool((cval[crow == 0] > 0).all())


def test_merge_plain_rejects_oversized_tiles():
    _, t, x, _ = _inputs(CASES["grid2d"])
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    tr, tn = merge_tile_coordinates(re_, t.num_nonzeros, 1024)
    with pytest.raises(ValueError, match="tile_items"):
        K.merge_tile_plain(v, ci, re_, torch.from_numpy(x), tr, tn, 512)


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    _, t, x, _ = _inputs(CASES["powerlaw"])
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    tr, tn = merge_tile_coordinates(re_, t.num_nonzeros, 1024)
    K.reset_launches()
    a = K.merge_csrmv(v, ci, re_, torch.from_numpy(x), tr, tn, 1024)
    b = K.merge_csrmv_plain(v, ci, re_, torch.from_numpy(x), tr, tn, 1024)
    assert torch.equal(a, b)
    assert K.LAUNCHES == {"merge_tile": 0, "merge_tile_fused": 0,
                          "carry_fixup": 0, "merge_tile_mm": 0}


# ---------------------------------------------------------------------- #
# The operator (device="cpu") and the functional API
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_cpu_vs_jax(name):
    j, t, x, yi = _inputs(CASES[name], seed=2, y_in=True)
    op = build_operator(t, dtype="float32", device="cpu", tile_items=1024)
    assert op.plan.backend == "torch"
    got = op(torch.from_numpy(x)).numpy()
    want = _jax_reference(j, x, None, 1.0, 0.0, 1024, interpret=False)
    _assert_close(got, want, j.spmv_abs_bound(x), name)
    got = op(torch.from_numpy(x), y_in=torch.from_numpy(yi), alpha=2.0,
             beta=1.0).numpy()
    want = _jax_reference(j, x, yi, 2.0, 1.0, 1024, interpret=False)
    _assert_close(got, want, j.spmv_abs_bound(x, yi, 2.0, 1.0), name)


def test_operator_mm_vs_jax():
    j, t, _, _ = _inputs(CASES["powerlaw"])
    rs = np.random.RandomState(4)
    X = rs.uniform(0.1, 1, (j.num_cols, 3)).astype(np.float32)
    Y_in = rs.uniform(0.1, 1, (j.num_rows, 3)).astype(np.float32)
    op = build_operator(t, device="cpu", tile_items=2048)
    got = op.mm(torch.from_numpy(X), Y_in=torch.from_numpy(Y_in), alpha=1.5,
                beta=0.5).numpy()
    v, re_, ci = j.to_device(dtype=np.float32)
    want = np.asarray(jx.csrmm_xla(v, re_, ci, jnp.asarray(X),
                                   Y_in=jnp.asarray(Y_in), alpha=1.5,
                                   beta=0.5))
    for k in range(3):
        _assert_close(got[:, k], want[:, k],
                      j.spmv_abs_bound(X[:, k], Y_in[:, k], 1.5, 0.5),
                      f"mm[:, {k}]")
    with pytest.raises(ValueError, match="wide"):
        op.mm(torch.from_numpy(X), method="wide")


@pytest.mark.parametrize("name", ["wheel_hub_spans_tiles", "powerlaw"])
def test_operator_fp64_vs_float64_gold(name):
    _, t, x, _ = _inputs(CASES[name], seed=7, dtype=np.float64)
    op = build_operator(t, dtype="float64", device="cpu", tile_items=1024)
    y = op(torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), t.spmv_gold(x), rtol=1e-12, atol=0)


def test_operator_bf16_end_to_end():
    """bfloat16 computes in float32 and casts back (mirrors
    test_csrmv_xla.py::test_bf16_operator_end_to_end)."""
    t = CsrMatrix.from_coo(CooMatrix.grid2d(30))
    op = build_operator(t, dtype="bfloat16", device="cpu")
    assert op.values.dtype == torch.float32
    y = op(torch.ones(t.num_cols, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    gold = t.astype(np.float32).spmv_gold(np.ones(t.num_cols, np.float32))
    # integer-valued stencil sums are exactly representable in bf16
    assert np.max(np.abs(y.float().numpy() - gold)) == 0.0


def test_operator_repeat_calls_are_bitwise_equal():
    _, t, x, _ = _inputs(CASES["wheel_hub_spans_tiles"], signed=True)
    op = build_operator(t, device="cpu", tile_items=256)
    assert torch.equal(op(torch.from_numpy(x)), op(torch.from_numpy(x)))


def test_operator_describe_names_ignored_knobs():
    _, t, _, _ = _inputs(CASES["grid2d_small"])
    op = build_operator(t, device="cpu", gather_group=4, runtime_skip=True)
    text = op.describe()
    for knob in ("gather_group=4", "runtime_skip=True", "gather_cluster",
                 "ignored"):
        assert knob in text
    # autotune is a knob of the port's own (ops/autotune.py), not ignored
    assert "autotune" not in text
    assert set(op.setup_s) == {"plan", "prepare"}


def test_operator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    _, t, _, _ = _inputs(CASES["grid2d_small"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_operator(t)
    with pytest.raises(ValueError, match="does not run"):
        build_operator(t, device="cpu", backend="cuda")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_functional_csrmv_csrmm(backend):
    """A "cuda" plan on CPU tensors runs the kernels' plain versions; the
    "torch" plan (the CPU's) runs the segment-sum oracle."""
    j, t, x, yi = _inputs(CASES["powerlaw"], seed=3, y_in=True)
    plan = make_plan(t.num_rows, t.num_cols, t.num_nonzeros,
                     tile_items=1024, backend=backend, num_rhs=2,
                     device="cuda" if backend == "cuda" else "cpu")
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    got = csrmv(plan, v, re_, ci, torch.from_numpy(x),
                y_in=torch.from_numpy(yi), alpha=2.5, beta=-0.5).numpy()
    _assert_close(got, j.spmv_gold(x, yi, 2.5, -0.5),
                  j.spmv_abs_bound(x, yi, 2.5, -0.5), backend)
    fn = csrmv_fn(plan)
    _assert_close(fn(v, re_, ci, torch.from_numpy(x)).numpy(),
                  j.spmv_gold(x), j.spmv_abs_bound(x), backend)
    X = np.stack([x, x[::-1].copy()], axis=1)
    Y = csrmm(plan, v, re_, ci, torch.from_numpy(X)).numpy()
    for k in range(2):
        _assert_close(Y[:, k], j.spmv_gold(X[:, k]),
                      j.spmv_abs_bound(X[:, k]), f"{backend} mm")


def test_torch_backend_refuses_card_tensors():
    """The "torch" backend is the plain version: handed a tensor on the
    card it raises instead of running the oracle there.  A stand-in that
    reports ``is_cuda`` plays the card's tensor on a machine without one."""
    _, t, x, _ = _inputs(CASES["grid2d_small"])
    plan = make_plan(t.num_rows, t.num_cols, t.num_nonzeros, device="cpu")
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    on_card = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError, match="CPU tensors only"):
        csrmv(plan, v, re_, ci, on_card)
    with pytest.raises(ValueError, match="CPU tensors only"):
        csrmv(plan, on_card, re_, ci, torch.from_numpy(x))
    X = torch.from_numpy(np.stack([x, x], axis=1))
    with pytest.raises(ValueError, match="CPU tensors only"):
        csrmm(plan, on_card, re_, ci, X)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_functional_api_checks_operand_shapes(backend):
    _, t, x, yi = _inputs(CASES["powerlaw"], y_in=True)
    plan = make_plan(t.num_rows, t.num_cols, t.num_nonzeros,
                     tile_items=1024, backend=backend,
                     device="cuda" if backend == "cuda" else "cpu")
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    xs, ys = torch.from_numpy(x), torch.from_numpy(yi)
    with pytest.raises(ValueError, match="x must have shape"):
        csrmv(plan, v, re_, ci, xs[:-1])
    with pytest.raises(ValueError, match="y_in must have shape"):
        csrmv(plan, v, re_, ci, xs, y_in=ys[:-1], beta=1.0)
    with pytest.raises(ValueError, match="X must have shape"):
        csrmm(plan, v, re_, ci, xs)
    with pytest.raises(ValueError, match="Y_in must have shape"):
        csrmm(plan, v, re_, ci, torch.stack([xs, xs], 1),
              Y_in=torch.stack([ys, ys, ys], 1))


def test_operator_checks_operand_shapes():
    _, t, x, yi = _inputs(CASES["powerlaw"], y_in=True)
    op = build_operator(t, device="cpu", tile_items=1024)
    xs, ys = torch.from_numpy(x), torch.from_numpy(yi)
    with pytest.raises(ValueError, match="x must have shape"):
        op(xs[:-1])
    with pytest.raises(ValueError, match="x must have shape"):
        op(torch.cat([xs, xs]))
    with pytest.raises(ValueError, match="y_in must have shape"):
        op(xs, y_in=ys[1:], beta=1.0)
    with pytest.raises(ValueError, match="X must have shape"):
        op.mm(torch.stack([xs[1:], xs[1:]], 1))
    with pytest.raises(ValueError, match="Y_in must have shape"):
        op.mm(torch.stack([xs, xs], 1), Y_in=ys[:, None])


def test_tile_wrapper_checks_the_tile_size():
    """Tile coordinates searched at another tile size are refused before
    any kernel or plain version runs."""
    _, t, x, _ = _inputs(CASES["powerlaw"])
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    tr, tn = merge_tile_coordinates(re_, t.num_nonzeros, 256)
    with pytest.raises(ValueError, match="another tile size"):
        K.merge_tile(v, ci, re_, torch.from_numpy(x), tr, tn, 1024)
    with pytest.raises(ValueError, match="another tile size"):
        K.merge_csrmv(v, ci, re_, torch.from_numpy(x), tr[:-1], tn[:-1], 256)


# ---------------------------------------------------------------------- #
# csrmv_torch (the oracle) vs csrmv_xla
# ---------------------------------------------------------------------- #

XLA_MATRICES = {
    "grid2d": lambda: jcoo.CooMatrix.grid2d(12),
    "grid3d": lambda: jcoo.CooMatrix.grid3d(5),
    "wheel": lambda: jcoo.CooMatrix.wheel(200),
    "dense": lambda: jcoo.CooMatrix.dense(16, 24),
    "powerlaw": lambda: jcoo.CooMatrix.random_powerlaw(300, 250, 3000,
                                                       seed=4),
    "empty_rows": lambda: jcoo.CooMatrix(7, 5, rows=[2, 2, 5],
                                         cols=[0, 4, 3], vals=[1., 2., 3.]),
    "duplicates": lambda: jcoo.CooMatrix(3, 3, rows=[0, 0, 0],
                                         cols=[1, 1, 1], vals=[1., 2., 3.]),
    "one_col": lambda: jcoo.CooMatrix(6, 1, rows=[0, 2, 2, 5],
                                      cols=[0, 0, 0, 0],
                                      vals=[1., 2., 3., 4.]),
}


@pytest.mark.parametrize("name", sorted(XLA_MATRICES))
def test_csrmv_torch_vs_xla(name):
    j, t, x, yi = _inputs(XLA_MATRICES[name], seed=1, signed=True,
                          y_in=True)
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    got = tt.csrmv_torch(v, re_, ci, torch.from_numpy(x),
                         y_in=torch.from_numpy(yi), alpha=2.5,
                         beta=-0.5).numpy()
    jv, jre, jci = j.to_device(dtype=np.float32)
    want = np.asarray(jx.csrmv_xla(jv, jre, jci, jnp.asarray(x),
                                   y_in=jnp.asarray(yi), alpha=2.5,
                                   beta=-0.5))
    _assert_close(got, want, j.spmv_abs_bound(x, yi, 2.5, -0.5), name)


def test_csrmm_torch_vs_xla():
    j, t, _, _ = _inputs(XLA_MATRICES["powerlaw"], signed=True)
    X = np.random.RandomState(8).uniform(-1, 1, (j.num_cols, 8)).astype(
        np.float32)
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    got = tt.csrmm_torch(v, re_, ci, torch.from_numpy(X)).numpy()
    jv, jre, jci = j.to_device(dtype=np.float32)
    want = np.asarray(jx.csrmm_xla(jv, jre, jci, jnp.asarray(X)))
    for k in range(8):
        _assert_close(got[:, k], want[:, k], j.spmv_abs_bound(X[:, k]),
                      f"csrmm[:, {k}]")


def test_empty_matrix():
    t = CsrMatrix(3, 3, [0, 0, 0, 0], [], np.zeros(0, np.float32))
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(
        tt.csrmv_torch(v, re_, ci, torch.ones(3)).numpy(), np.zeros(3))
    op = build_operator(t, device="cpu")
    np.testing.assert_array_equal(op(torch.ones(3)).numpy(), np.zeros(3))


def test_sorted_segment_sum_vs_xla():
    """The scatter-free form on skewed rows, empty rows and a nnz that is
    not a multiple of 1024, against the JAX twin and gold
    (mirrors test_csrmv_xla.py:118-146)."""
    rs = np.random.RandomState(9)
    n = 3000
    raw = rs.pareto(1.3, n) + 1.0
    deg = np.maximum(0, (raw * (12 * n / raw.sum())).astype(np.int64))
    deg[::7] = 0
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    j = jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(
        n, n, rows, rs.randint(0, n, rows.size),
        rs.uniform(-1, 1, rows.size))).astype(np.float32)
    x = rs.uniform(-1, 1, n).astype(np.float32)
    products = j.values * x[j.col_indices]
    got = tt._sorted_segment_sum(torch.from_numpy(products),
                                 torch.from_numpy(j.row_offsets[1:])).numpy()
    want = np.asarray(jx._sorted_segment_sum(
        jnp.asarray(products), jnp.asarray(j.row_offsets[1:])))
    bound = j.spmv_abs_bound(x)
    _assert_close(got, want, bound, "vs xla")
    _assert_close(got, j.spmv_gold(x), bound, "vs gold")


def test_sorted_segment_sum_compensated_prefix(monkeypatch):
    """Forced onto the scatter-free route, signed products drive the
    running prefix far from the small rows' sums; the compensated block
    prefix keeps them in the block-local error class (mirrors
    test_csrmv_xla.py:149-184)."""
    rs = np.random.RandomState(3)
    n, deg = 40000, 8
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    t = CsrMatrix.from_coo(CooMatrix(
        n, n, rows, rs.randint(0, n, rows.size),
        rs.uniform(-1.0, 1.0, rows.size).astype(np.float32)))
    x = rs.uniform(0.5, 1.5, n).astype(np.float32)
    X = rs.uniform(-1, 1, (n, 2)).astype(np.float32)
    v, re_, ci = t.to_device(device="cpu")
    monkeypatch.setattr(tt, "_SCATTER_NNZ_CAP", 1 << 14)
    y = tt.csrmv_torch(v, re_, ci, torch.from_numpy(x)).numpy()
    Y = tt.csrmm_torch(v, re_, ci, torch.from_numpy(X)).numpy()
    _assert_close(y, t.spmv_gold(x), t.spmv_abs_bound(x), "csrmv")
    np.testing.assert_allclose(Y, t.spmm_gold(X), rtol=3e-4, atol=3e-4)


def test_twofloat_scan_is_exclusive_and_compensated():
    x = torch.tensor([1e8, 1.0, -1e8, 3.0, 0.5], dtype=torch.float32)
    hi, lo = tt._twofloat_exclusive_scan(x)
    assert hi[0] == 0 and lo[0] == 0
    exact = np.concatenate([[0.0], np.cumsum(x.double().numpy())[:-1]])
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(), exact,
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #

def test_package_imports_no_jax():
    """The port imports neither jax nor merge_spmv_tpu (a fresh
    interpreter, so this file's own imports do not count), and importing
    every module of it compiles nothing: no CUDA kernel library and no
    host library (csrc/market_io.cpp) is built or loaded."""
    code = ("import sys, merge_spmv_tpu_torch, merge_spmv_tpu_torch.ops, "
            "merge_spmv_tpu_torch.ops.csrmv_cuda, "
            "merge_spmv_tpu_torch.ops.dia, merge_spmv_tpu_torch.ops.dia_cuda, "
            "merge_spmv_tpu_torch.ops.split, merge_spmv_tpu_torch.ops.suggest, "
            "merge_spmv_tpu_torch.ops.autotune, "
            "merge_spmv_tpu_torch.bench.matrices, "
            "merge_spmv_tpu_torch.bench.driver, merge_spmv_tpu_torch.cli, "
            "merge_spmv_tpu_torch.tools.sm_ceiling, "
            "merge_spmv_tpu_torch.utils.timers, "
            "merge_spmv_tpu_torch.utils.cuda_build, "
            "merge_spmv_tpu_torch.models.solvers, "
            "merge_spmv_tpu_torch.parallel.partition, "
            "merge_spmv_tpu_torch.parallel.distributed, "
            "merge_spmv_tpu_torch.parallel.mp_worker, "
            "merge_spmv_tpu_torch.bench.headline, "
            "merge_spmv_tpu_torch.formats.native_io, "
            "merge_spmv_tpu_torch.utils.hostmem, "
            "merge_spmv_tpu_torch.utils.host_build, "
            "merge_spmv_tpu_torch.tools.make_corpus, "
            "merge_spmv_tpu_torch.tools.make_corpus_stats, "
            "merge_spmv_tpu_torch.tools.eval_corpus, "
            "merge_spmv_tpu_torch.tools.corpus_stats, "
            "merge_spmv_tpu_torch.bench.measure, "
            "merge_spmv_tpu_torch.tools.bench_baseline_configs, "
            "merge_spmv_tpu_torch.tools.bench_spmm, "
            "merge_spmv_tpu_torch.tools.bench_skew, "
            "merge_spmv_tpu_torch.tools.bench_multichip, "
            "merge_spmv_tpu_torch.tools.bench_large, "
            "merge_spmv_tpu_torch.tools.bench_hotcold, "
            "merge_spmv_tpu_torch.tools.split_compact_bench; "
            "from merge_spmv_tpu_torch.utils.cuda_build import _LOADED; "
            "assert not _LOADED, _LOADED; "
            "from merge_spmv_tpu_torch.utils.host_build import BUILT; "
            "assert not BUILT, BUILT; "
            "from merge_spmv_tpu_torch.formats import native_io; "
            "assert native_io._LIB is None and not native_io._TRIED; "
            "from merge_spmv_tpu_torch.utils import hostmem; "
            "assert not hostmem._enabled; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'merge_spmv_tpu' "
            "or m.startswith('merge_spmv_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
