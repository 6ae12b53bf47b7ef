"""The port's DIA operator held against the JAX package's on the same inputs.

Each case of tests/test_dia.py runs through both packages from the same
numpy arrays: the diagonal choice (offsets and mask) and the (D, m) table
must be equal, and the port's ``op(x)``, ``op(x, y_in, alpha, beta)`` and
``op.mm(X)`` on ``device="cpu"`` (the DIA kernel's plain version, the merge
kernels' plain versions for the leftover) must agree with the JAX
operator's XLA chain, with ``op(x, interpret=True)`` (the Pallas kernel in
interpret mode) and with ``dia_matvec_pallas(..., interpret=True)``.

Tolerances: float32 by ``compare_results(..., abs_bound=spmv_abs_bound)``;
float64 ``rtol=1e-12``; bfloat16 ``|port - jax| <= 2^-6 * |A|.|x|`` per
row (each package rounds to bfloat16 at other places: the JAX chain after
each of up to D multiply-adds, 2^-9 each, the port once at the end).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
from merge_spmv_tpu.ops.dia import build_dia_operator as jbuild_dia
from merge_spmv_tpu.ops.dia import diagonal_assignment as jdiagonal_assignment
from merge_spmv_tpu.ops.dia_pallas import dia_matvec_pallas
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import dia_cuda as K
from merge_spmv_tpu_torch.ops.dia import (build_dia_operator,
                                          diagonal_assignment)
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.timers import chain_alpha


def _scatter():
    n, deg = 6000, 9
    rs = np.random.RandomState(4)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    return jcoo.CooMatrix(n, n, rows, rs.randint(0, n, rows.size),
                          rs.uniform(-1, 1, rows.size))


def _mixed():
    # stencil plus a sprinkle of scattered entries: leftover CSR chains
    base = jcoo.CooMatrix.grid2d(40)
    rs = np.random.RandomState(2)
    extra = 300
    return jcoo.CooMatrix(
        1600, 1600, np.concatenate([base.rows, rs.randint(0, 1600, extra)]),
        np.concatenate([base.cols, rs.randint(0, 1600, extra)]),
        np.concatenate([base.vals, rs.uniform(-1, 1, extra)]))


def _duplicates():
    return jcoo.CooMatrix(3, 3, np.array([0, 0, 1, 2, 2, 2]),
                          np.array([0, 0, 1, 2, 2, 0]),
                          np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]))


def _rectangular():
    m, n = 300, 400
    rows = np.concatenate([np.arange(m), np.arange(m)]).astype(np.int64)
    cols = np.concatenate([np.arange(m), np.arange(m) + 50]).astype(np.int64)
    return jcoo.CooMatrix(m, n, rows, cols,
                          np.random.RandomState(0).uniform(-1, 1, 2 * m))


# name -> (matrix, min_coverage, signed random values from this seed or
# None to keep the generator's values); the tests/test_dia.py cases
CASES = {
    "grid3d10": (lambda: jcoo.CooMatrix.grid3d(10), 0.5, None),
    "grid3d12": (lambda: jcoo.CooMatrix.grid3d(12), 0.5, 3),
    "grid3d17": (lambda: jcoo.CooMatrix.grid3d(17), 0.5, 1),
    "grid2d30": (lambda: jcoo.CooMatrix.grid2d(30), 0.5, None),
    "grid2d37": (lambda: jcoo.CooMatrix.grid2d(37), 0.5, 1),
    "mixed": (_mixed, 0.5, None),
    "duplicates": (_duplicates, 0.3, None),
    "rectangular": (_rectangular, 0.5, None),
    "scatter": (_scatter, 0.5, None),
}


def _pair(name, dtype=np.float32):
    """The case's JAX-package CSR and its port twin on identical arrays."""
    make, _, seed = CASES[name]
    j = jcsr.CsrMatrix.from_coo(make()).astype(dtype)
    if seed is not None:
        j.values = np.random.RandomState(seed).uniform(
            -1, 1, j.num_nonzeros).astype(dtype)
    t = CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                              j.col_indices, j.values)
    return j, t


def _ops(name, dtype="float32"):
    j, t = _pair(name, np.float64 if dtype == "float64" else np.float32)
    cov = CASES[name][1]
    return (j, t, jbuild_dia(j, dtype=dtype, min_coverage=cov),
            build_dia_operator(t, dtype=dtype, min_coverage=cov,
                               device="cpu"))


def _vec(n, seed, lo=-1.0):
    return np.random.RandomState(seed).uniform(lo, 1, n).astype(np.float32)


def _assert_close(got, want, bound, context):
    idx = compare_results(got, want, verbose=False, abs_bound=bound)
    assert idx is None, (f"{context}: [{idx}] got {got.ravel()[idx]!r} "
                         f"want {want.ravel()[idx]!r}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_diagonal_assignment_and_table_match_jax(name):
    j, t = _pair(name)
    cov = CASES[name][1]
    offs_j, mask_j = jdiagonal_assignment(j, min_coverage=cov)
    offs_t, mask_t = diagonal_assignment(t, min_coverage=cov)
    np.testing.assert_array_equal(offs_t, offs_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    _, _, jop, op = _ops(name)
    np.testing.assert_array_equal(op.offsets, jop.offsets)
    assert (op.dia_nnz, op.rest_nnz) == (jop.dia_nnz, jop.rest_nnz)
    assert (op.rest_op is None) == (jop.rest_op is None)
    if jop.vtab is None:
        assert op.vtab is None
    else:
        np.testing.assert_array_equal(op.vtab.numpy(), np.asarray(jop.vtab))
        assert op.offsets_t.dtype == torch.int64


def test_grid3d_offsets_are_the_stencil():
    _, _, _, op = _ops("grid3d12")
    assert set(op.offsets.tolist()) == {-144, -12, -1, 1, 12, 144}
    _, _, _, op = _ops("scatter")
    assert op.offsets.size == 0 and op.rest_nnz == op.plan.num_nonzeros


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_and_gold(name):
    j, _, jop, op = _ops(name)
    x = _vec(j.num_cols, 11)
    got = op(torch.from_numpy(x)).numpy()
    bound = j.spmv_abs_bound(x)
    _assert_close(got, np.asarray(jop(jnp.asarray(x))), bound, "vs jax")
    _assert_close(got, j.spmv_gold(x), bound, "vs gold")


@pytest.mark.parametrize("name", ["grid3d12", "mixed", "duplicates",
                                  "grid2d37"])
def test_op_matches_jax_pallas_interpret(name):
    """The JAX operator through its Pallas kernel in interpret mode (the
    gate passes for these float32 tables), as test_dia.py:165 drives it."""
    j, _, jop, op = _ops(name)
    x = _vec(j.num_cols, 3)
    got = op(torch.from_numpy(x)).numpy()
    want = np.asarray(jop(jnp.asarray(x), interpret=True))
    _assert_close(got, want, j.spmv_abs_bound(x), "vs jax interpret")


@pytest.mark.parametrize("name", ["grid3d17", "grid2d37", "rectangular"])
def test_dia_matvec_plain_matches_pallas_interpret(name):
    """The kernel's plain version against the Pallas DIA kernel itself."""
    j, _, jop, op = _ops(name)
    x = _vec(j.num_cols, 1)
    want = np.asarray(dia_matvec_pallas(
        jop.vtab, jnp.asarray(x), tuple(int(o) for o in jop.offsets),
        jop.num_rows, jop.num_cols, interpret=True))
    K.reset_launches()
    got = K.dia_matvec(op.vtab, torch.from_numpy(x), op.offsets_t,
                       op.num_rows, op.num_cols).numpy()
    assert K.LAUNCHES == {"dia_matvec": 0, "dia_matmat": 0}
    bound = j.spmv_abs_bound(x)
    _assert_close(got, want, bound, "vs pallas")
    _assert_close(got, j.spmv_gold(x), bound, "vs gold")


@pytest.mark.parametrize("name", ["grid3d10", "mixed", "rectangular",
                                  "scatter"])
def test_alpha_beta_epilogue_matches_jax(name):
    j, _, jop, op = _ops(name)
    x, y0 = _vec(j.num_cols, 0), _vec(j.num_rows, 5)
    got = op(torch.from_numpy(x), y_in=torch.from_numpy(y0), alpha=1.5,
             beta=-0.5).numpy()
    want = np.asarray(jop(jnp.asarray(x), y_in=jnp.asarray(y0), alpha=1.5,
                          beta=-0.5))
    bound = j.spmv_abs_bound(x, y0, alpha=1.5, beta=-0.5)
    _assert_close(got, want, bound, "vs jax")
    _assert_close(got, j.spmv_gold(x, y0, alpha=1.5, beta=-0.5), bound,
                  "vs gold")


@pytest.mark.parametrize("name", ["grid2d30", "mixed"])
def test_mm_matches_jax(name):
    j, _, jop, op = _ops(name)
    rs = np.random.RandomState(1)
    X = rs.uniform(-1, 1, (j.num_cols, 3)).astype(np.float32)
    Y_in = rs.uniform(-1, 1, (j.num_rows, 3)).astype(np.float32)
    got = op.mm(torch.from_numpy(X), Y_in=torch.from_numpy(Y_in), alpha=2.0,
                beta=0.5).numpy()
    want = np.asarray(jop.mm(jnp.asarray(X), Y_in=jnp.asarray(Y_in),
                             alpha=2.0, beta=0.5))
    for k in range(3):
        bound = j.spmv_abs_bound(X[:, k], Y_in[:, k], 2.0, 0.5)
        _assert_close(got[:, k], want[:, k], bound, f"mm[:, {k}] vs jax")
        _assert_close(got[:, k], j.spmv_gold(X[:, k], Y_in[:, k], 2.0, 0.5),
                      bound, f"mm[:, {k}] vs gold")
    with pytest.raises(ValueError, match="wide"):
        op.mm(torch.from_numpy(X), method="wide")


def test_duplicates_are_summed_in_the_table():
    j, _, _, op = _ops("duplicates")
    x = np.array([1.0, 10.0, 100.0], np.float32)
    np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(),
                               j.spmv_gold(x), rtol=1e-6)
    assert float(op.vtab[op.offsets.tolist().index(0), 0]) == 3.0


@pytest.mark.parametrize("name", ["grid2d30", "mixed"])
def test_float64_matches_jax_and_gold(name):
    jax.config.update("jax_enable_x64", True)
    try:
        j, _, jop, op = _ops(name, dtype="float64")
        x = np.random.RandomState(2).uniform(-1, 1, j.num_cols)
        want = np.asarray(jop(jnp.asarray(x)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert op.vtab.dtype == torch.float64
    got = op(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), j.spmv_gold(x), rtol=1e-12)


@pytest.mark.parametrize("name", ["grid2d30", "mixed"])
def test_bfloat16_matches_jax(name):
    """bfloat16: the port rounds the table and x to bfloat16, computes in
    float32 and rounds once; the JAX chain rounds after each step."""
    j, t, jop, op = _ops(name, dtype="bfloat16")
    x = _vec(j.num_cols, 6, lo=0.1)
    got = op(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and op.vtab.dtype == torch.float32
    want = np.asarray(jop(jnp.asarray(x))).astype(np.float32)
    scale = j.spmv_abs_bound(x, segmented_block=0)
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -6 * scale).all(), float((err / scale).max())
    # against float32 arithmetic on the bfloat16-rounded values: one
    # rounding of the result (2^-9) plus float32 sums
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    rounded = t.astype(np.float32)
    rounded.values = torch.from_numpy(t.values).bfloat16().float().numpy()
    err = np.abs(got.float().numpy() - rounded.spmv_gold(xb))
    assert (err <= 2.0 ** -8 * rounded.spmv_abs_bound(xb,
                                                      segmented_block=0)).all()


def test_chain_alpha_is_the_inverse_row_norm():
    """The timers' chain alpha is 1 / max_r sum_j |A[r, j]|, from the
    norm each operator takes once at build."""
    for name in ("mixed", "grid3d12", "rectangular"):
        _, t = _pair(name)
        want = 1.0 / np.abs(t.to_dense().astype(np.float64)).sum(1).max()
        dia = build_dia_operator(t, device="cpu")
        merge = build_operator(t, device="cpu")
        assert chain_alpha(dia) == pytest.approx(want, rel=1e-12)
        assert chain_alpha(merge) == pytest.approx(want, rel=1e-12)
    empty = CsrMatrix(3, 3, [0, 0, 0, 0], [], np.zeros(0, np.float32))
    assert chain_alpha(build_dia_operator(empty, device="cpu")) == 1.0


def test_operand_shapes_are_checked():
    _, _, _, op = _ops("rectangular")
    x = torch.ones(op.num_cols)
    with pytest.raises(ValueError, match="x must have shape"):
        op(x[:-1])
    with pytest.raises(ValueError, match="y_in must have shape"):
        op(x, y_in=torch.ones(op.num_cols), beta=1.0)
    with pytest.raises(ValueError, match="X must have shape"):
        op.mm(torch.ones(op.num_rows, 2))


def test_dia_matvec_wrapper_counts_only_kernel_launches():
    _, _, _, op = _ops("grid3d10")
    x = torch.from_numpy(_vec(op.num_cols, 4))
    K.reset_launches()
    a = K.dia_matvec(op.vtab, x, op.offsets_t, op.num_rows, op.num_cols, 2.0)
    b = K.dia_matvec_plain(op.vtab, x, op.offsets_t, op.num_rows,
                           op.num_cols, 2.0)
    assert torch.equal(a, b)
    assert K.LAUNCHES == {"dia_matvec": 0, "dia_matmat": 0}


def test_build_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    _, t = _pair("grid2d30")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dia_operator(t)
