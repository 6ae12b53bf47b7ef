"""The TPU package's keywords at the port's entry points.

The port accepts and ignores the JAX package's TPU knobs, so that a caller
of either package can call the other: ``interpret`` in every operator's
``__call__`` and ``mm`` (before ``method``, in the JAX position),
``use_native`` in ``CsrMatrix.from_coo`` and ``CooMatrix.from_market``,
and the gather, window and VMEM knobs of ``make_plan``.  Each entry point
is called here with the JAX keyword set, on the CPU, and its result held
against the JAX package's on the same numpy inputs: bit for bit where both
only move arrays, and within the backward-error bound of
``spmv_abs_bound`` (the rule bench.py:74 applies) where both compute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
import merge_spmv_tpu.ops.dia as jdia
import merge_spmv_tpu.ops.operator as jop_mod
import merge_spmv_tpu.ops.plan as jplan
import merge_spmv_tpu.ops.split as jsplit
from merge_spmv_tpu.ops.csrmv import csrmv as jcsrmv
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import split as S
from merge_spmv_tpu_torch.ops.csrmv import csrmv
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops import plan as P
from merge_spmv_tpu_torch.ops.plan import make_plan
from merge_spmv_tpu_torch.utils.compare import compare_results

OPERATORS = ("merge", "dia", "split", "hotcold")


def _matrix():
    """A 2-D stencil with scattered extras and a few popular columns:
    every operator has work in each of its parts."""
    rs = np.random.RandomState(11)
    base = jcoo.CooMatrix.grid2d(24)
    n = base.num_rows
    extra = 400
    hubs = rs.choice(n, 6, replace=False)
    rows = np.r_[base.rows, rs.randint(0, n, extra), rs.randint(0, n, 300)]
    cols = np.r_[base.cols, rs.randint(0, n, extra),
                 hubs[rs.randint(0, 6, 300)]]
    vals = rs.uniform(-1, 1, rows.size)
    j = jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(n, n, rows, cols, vals)
                                ).astype(np.float32)
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    return j, t


def _build(kind, j, t):
    if kind == "merge":
        return (build_operator(t, device="cpu"),
                jop_mod.build_operator(j, backend="xla"))
    if kind == "dia":
        return build_dia_operator(t, device="cpu"), jdia.build_dia_operator(j)
    if kind == "split":
        return (S.build_split_operator(t, edges_chunks=(1, 2),
                                       tile_items=2048, device="cpu"),
                jsplit.build_split_operator(j, edges_chunks=(1, 2),
                                            tile_items=2048))
    return (S.build_hotcold_operator(t, min_gain=1.5, device="cpu"),
            jsplit.build_hotcold_operator(j, min_gain=1.5))


def _close(got, want, bound):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.shape(want)
    assert compare_results(got, np.asarray(want), verbose=False,
                           abs_bound=bound) is None


@pytest.mark.parametrize("kind", OPERATORS)
def test_operator_call_takes_interpret(kind):
    """op(x, y_in, alpha, beta, interpret=...) on both packages."""
    j, t = _matrix()
    op, jop = _build(kind, j, t)
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, t.num_cols).astype(np.float32)
    y0 = rs.uniform(-1, 1, t.num_rows).astype(np.float32)
    got = op(torch.from_numpy(x), torch.from_numpy(y0), 1.5, -0.5,
             interpret=False)
    want = jop(jnp.asarray(x), jnp.asarray(y0), 1.5, -0.5, interpret=True)
    bound = j.spmv_abs_bound(x, y0, 1.5, -0.5)
    _close(got, want, bound)
    _close(got, j.spmv_gold(x, y0, 1.5, -0.5), bound)


@pytest.mark.parametrize("kind", OPERATORS)
def test_operator_mm_takes_interpret_before_method(kind):
    """op.mm(X, Y_in, alpha, beta, interpret, method) positionally, as the
    JAX package orders them: the fifth argument is ``interpret``."""
    j, t = _matrix()
    op, jop = _build(kind, j, t)
    X = np.random.RandomState(3).uniform(-1, 1, (t.num_cols, 2)).astype(
        np.float32)
    got = op.mm(torch.from_numpy(X), None, 1.0, 0.0, False, "auto")
    want = jop.mm(jnp.asarray(X), None, 1.0, 0.0, True, "auto")
    for k in range(X.shape[1]):
        bound = j.spmv_abs_bound(X[:, k])
        _close(got[:, k], np.asarray(want)[:, k], bound)
        _close(got[:, k], j.spmv_gold(X[:, k]), bound)


def test_from_coo_and_from_market_take_use_native(tmp_path):
    """The same CSR arrays as the JAX package's, given use_native=False."""
    j, t = _matrix()
    coo = CooMatrix(t.num_rows, t.num_cols, t.row_ids(), t.col_indices,
                    t.values)
    jc = jcoo.CooMatrix(j.num_rows, j.num_cols, j.row_ids(), j.col_indices,
                        j.values)
    a = CsrMatrix.from_coo(coo, use_native=False)
    b = jcsr.CsrMatrix.from_coo(jc, use_native=False)
    path = str(tmp_path / "m.mtx")
    coo.to_market(path)
    c = CooMatrix.from_market(path, use_native=False)
    d = jcoo.CooMatrix.from_market(path, use_native=False)
    for name in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(c, name), getattr(d, name))
    assert (c.num_rows, c.num_cols) == (d.num_rows, d.num_cols)


def test_make_plan_takes_the_tpu_knobs():
    """Every make_plan knob of the JAX package, by keyword: the plan names
    them, ``num_merge_items`` matches, and csrmv over it gives the JAX
    result."""
    j, t = _matrix()
    knobs = dict(vmem_bytes=16 << 20, r_win=2048, meta_k=0, x_win=0,
                 row_span=0, row_end_offsets=j.row_end_offsets,
                 col_indices=j.col_indices, allow_x_streaming=False,
                 runtime_skip=False, gather_group=2, gather_cluster=False,
                 gather_style="chain", gather_dlist=False, scratch={})
    plan = make_plan(t.num_rows, t.num_cols, t.num_nonzeros, "float32", None,
                     "auto", 1, device="cpu", **knobs)
    jp = jplan.make_plan(j.num_rows, j.num_cols, j.num_nonzeros, "float32",
                         None, "xla", 1, **knobs)
    # col_indices picks the gather policy, as it tightens the JAX plan's
    # gather knobs; every other knob is ignored
    assert set(plan.ignored) == set(knobs) - {"col_indices"}
    assert plan.policy == P.gather_policy(t.num_rows, t.num_nonzeros,
                                          t.col_indices)
    assert "ignored TPU knobs" in plan.describe()
    assert plan.num_merge_items == jp.num_merge_items
    assert make_plan(10, 10, 30, device="cpu").ignored == ()
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, t.num_cols).astype(np.float32)
    v, re_, ci = t.to_device(dtype=torch.float32, device="cpu")
    got = csrmv(plan, v, re_, ci, torch.from_numpy(x), interpret=False)
    jv, jre, jci = j.to_device(dtype=np.float32)
    want = jcsrmv(jp, jv, jre, jci, jnp.asarray(x), interpret=False)
    bound = j.spmv_abs_bound(x)
    _close(got, want, bound)
    _close(got, j.spmv_gold(x), bound)
