"""The port's solvers (merge_spmv_tpu_torch/models/solvers.py) against the
JAX package's on the inputs of tests/test_solvers.py.

Each JAX solver runs on the CPU (XLA backend), each port solver over the
port's operator with device="cpu" (the kernels' plain versions).  Both are
held to the JAX tests' tolerances against NumPy linear algebra; the port's
solution agrees with JAX's at rtol 1e-3 (atol 1e-3 of the solution's
largest entry, for entries near zero), and its iteration count is within
2 of JAX's: the two sum in different orders, so iterations can part near
the tolerance (measured on these inputs: the same count for CG, CG over
DIA, BiCGSTAB, Jacobi and PageRank; power iteration stops at 11 where
JAX stops at 13, as |lambda_k - lambda_k-1| first falls below 1e-9 two
steps apart in the two summation orders).  Blocks of
check_every = 1 and 7 masked iterations give the same count and the same
bits.
"""

import numpy as np
import pytest
import torch

from merge_spmv_tpu.formats.coo import CooMatrix
from merge_spmv_tpu.formats.csr import CsrMatrix
from merge_spmv_tpu.models import solvers as JS
from merge_spmv_tpu.ops.dia import build_dia_operator as jax_dia
from merge_spmv_tpu.ops.operator import build_operator as jax_operator
from merge_spmv_tpu_torch.formats.csr import CsrMatrix as TCsr
from merge_spmv_tpu_torch.models import solvers as TS
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.operator import build_operator

ITER_SLACK = 2
CHECK_EVERY = (1, 7)


def _laplacian_csr(width=12):
    """tests/test_solvers.py::_laplacian_csr: L = D - A + I."""
    coo = CooMatrix.grid2d(width)
    csr = CsrMatrix.from_coo(coo)
    dense = -csr.to_dense()
    deg = -dense.sum(axis=1)
    np.fill_diagonal(dense, deg + 1.0)
    rows, cols = np.nonzero(dense)
    coo2 = CooMatrix(dense.shape[0], dense.shape[1], rows.astype(np.int32),
                     cols.astype(np.int32), dense[rows, cols])
    return CsrMatrix.from_coo(coo2), dense


def _dense_csr(dense):
    rows, cols = np.nonzero(dense)
    n, m = dense.shape
    return CsrMatrix.from_coo(CooMatrix(n, m, rows.astype(np.int32),
                                        cols.astype(np.int32),
                                        dense[rows, cols]))


def _port(csr):
    return TCsr.from_arrays(csr.num_rows, csr.num_cols, csr.row_offsets,
                            csr.col_indices, csr.values)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _runs(solve):
    """``solve(check_every)`` -> (solution, info) for each block size; the
    runs must agree in iterations and bits.  Returns the first run."""
    runs = [solve(c) for c in CHECK_EVERY]
    (x0, i0), rest = runs[0], runs[1:]
    for x, info in rest:
        assert int(info.iterations) == int(i0.iterations)
        assert torch.equal(x, x0)
        assert torch.equal(info.residual, i0.residual)
    for c, (_, info) in zip(CHECK_EVERY, runs):
        it = int(info.iterations)
        # one read per block, the last one finding the flag false
        assert info.host_reads == max(1, -(-it // c))
    return runs[0]


def _agree(port, jax_x, name):
    jax_x = np.asarray(jax_x)
    np.testing.assert_allclose(
        _np(port), jax_x, rtol=1e-3, atol=1e-3 * np.abs(jax_x).max(),
        err_msg=f"{name}: port vs JAX")


def _iters_agree(port_info, jax_info):
    assert abs(int(port_info.iterations) - int(jax_info.iterations)) \
        <= ITER_SLACK, (int(port_info.iterations), int(jax_info.iterations))


def test_conjugate_gradient_matches_solve():
    csr, dense = _laplacian_csr()
    rs = np.random.RandomState(0)
    b = rs.uniform(-1, 1, csr.num_rows).astype(np.float32)
    xj, ij = JS.conjugate_gradient(jax_operator(csr, dtype="float32"), b,
                                   tol=1e-6, maxiter=2000)
    op = build_operator(_port(csr), dtype="float32", device="cpu")
    x, info = _runs(lambda c: TS.conjugate_gradient(
        op, b, tol=1e-6, maxiter=2000, check_every=c))
    want = np.linalg.solve(dense, b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(xj), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(x), want, rtol=2e-3, atol=2e-3)
    _agree(x, xj, "cg")
    _iters_agree(info, ij)
    assert int(info.iterations) > 0


def test_bicgstab_nonsymmetric():
    rs = np.random.RandomState(1)
    n = 120
    dense = np.eye(n) * 8.0 + rs.uniform(-1, 1, (n, n)) * (rs.rand(n, n) < 0.05)
    csr = _dense_csr(dense)
    b = rs.uniform(-1, 1, n).astype(np.float32)
    xj, ij = JS.bicgstab(jax_operator(csr, dtype="float32"), b, tol=1e-6,
                         maxiter=500)
    op = build_operator(_port(csr), dtype="float32", device="cpu")
    x, info = _runs(lambda c: TS.bicgstab(op, b, tol=1e-6, maxiter=500,
                                          check_every=c))
    want = np.linalg.solve(dense, b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(xj), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(x), want, rtol=2e-3, atol=2e-3)
    _agree(x, xj, "bicgstab")
    _iters_agree(info, ij)


def test_jacobi_diagonally_dominant():
    csr, dense = _laplacian_csr(10)
    rs = np.random.RandomState(2)
    b = rs.uniform(-1, 1, csr.num_rows).astype(np.float32)
    diag = np.diag(dense).astype(np.float32)
    xj, ij = JS.jacobi(jax_operator(csr, dtype="float32"), diag, b,
                       tol=1e-6, maxiter=5000)
    op = build_operator(_port(csr), dtype="float32", device="cpu")
    x, info = _runs(lambda c: TS.jacobi(op, diag, b, tol=1e-6, maxiter=5000,
                                        check_every=c))
    want = np.linalg.solve(dense, b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(xj), want, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(_np(x), want, rtol=5e-3, atol=5e-3)
    _agree(x, xj, "jacobi")
    _iters_agree(info, ij)


def test_power_iteration_dominant_eigenvalue():
    rs = np.random.RandomState(3)
    n = 80
    m = rs.uniform(0, 1, (n, n)) * (rs.rand(n, n) < 0.2)
    dense = (m + m.T) / 2 + np.eye(n) * 0.1   # symmetric -> real spectrum
    csr = _dense_csr(dense)
    # JAX's PRNGKey stream is not reproduced: both start from this v0
    v0 = np.random.RandomState(30).standard_normal(n).astype(np.float32)
    lj, vj, ij = JS.power_iteration(jax_operator(csr, dtype="float32"),
                                    v0=v0, tol=1e-9, maxiter=3000)
    op = build_operator(_port(csr), dtype="float32", device="cpu")
    runs = [TS.power_iteration(op, v0=v0, tol=1e-9, maxiter=3000,
                               check_every=c) for c in CHECK_EVERY]
    lam, v, info = runs[0]
    for lam_c, v_c, info_c in runs[1:]:
        assert int(info_c.iterations) == int(info.iterations)
        assert torch.equal(lam_c, lam) and torch.equal(v_c, v)
    want = np.max(np.abs(np.linalg.eigvalsh(dense)))
    assert abs(float(lj) - want) / want < 1e-3
    assert abs(float(lam) - want) / want < 1e-3
    assert abs(float(lam) - float(lj)) / abs(float(lj)) < 1e-3
    _agree(v, vj, "power_iteration")
    _iters_agree(info, ij)


def test_power_iteration_seeded_start():
    """Without v0 the start comes from a generator seeded by ``seed``:
    the same seed gives the same bits."""
    rs = np.random.RandomState(3)
    n = 80
    m = rs.uniform(0, 1, (n, n)) * (rs.rand(n, n) < 0.2)
    dense = (m + m.T) / 2 + np.eye(n) * 0.1
    op = build_operator(_port(_dense_csr(dense)), dtype="float32",
                        device="cpu")
    a = TS.power_iteration(op, tol=1e-9, maxiter=3000, seed=5)
    b = TS.power_iteration(op, tol=1e-9, maxiter=3000, seed=5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    want = np.max(np.abs(np.linalg.eigvalsh(dense)))
    assert abs(float(a[0]) - want) / want < 1e-3


def test_pagerank_sums_to_one_and_ranks_hub():
    # star graph: every page links to page 0 -> page 0 dominates
    n = 50
    rs = np.random.RandomState(4)
    src = np.arange(1, n, dtype=np.int32)
    dst = np.zeros(n - 1, dtype=np.int32)
    extra_src = rs.randint(1, n, 60).astype(np.int32)
    extra_dst = rs.randint(1, n, 60).astype(np.int32)
    src = np.concatenate([src, extra_src])
    dst = np.concatenate([dst, extra_dst])
    out_deg = np.bincount(src, minlength=n).astype(np.float64)
    vals = 1.0 / out_deg[src]
    # P[dst, src]: column-stochastic transition matrix
    csr = CsrMatrix.from_coo(CooMatrix(n, n, dst, src, vals))
    prj, ij = JS.pagerank(jax_operator(csr, dtype="float32"), tol=1e-10,
                          maxiter=500)
    op = build_operator(_port(csr), dtype="float32", device="cpu")
    pr, info = _runs(lambda c: TS.pagerank(op, tol=1e-10, maxiter=500,
                                           check_every=c))
    for got in (np.asarray(prj), _np(pr)):
        assert abs(got.sum() - 1.0) < 1e-3
        assert got.argmax() == 0
    _agree(pr, prj, "pagerank")
    _iters_agree(info, ij)


def test_conjugate_gradient_over_dia_operator():
    """The DIA operator has the merge operator's call surface, so the
    solvers take it unchanged (tests/test_solvers.py:104)."""
    csr, dense = _laplacian_csr(10)
    jop = jax_dia(csr.astype(np.float32), dtype="float32")
    assert jop.offsets.size == 5 and jop.rest_op is None
    rs = np.random.RandomState(1)
    b = rs.uniform(-1, 1, csr.num_rows).astype(np.float32)
    xj, ij = JS.conjugate_gradient(jop, b, tol=1e-6, maxiter=2000)
    op = build_dia_operator(_port(csr.astype(np.float32)), dtype="float32",
                            device="cpu")
    assert op.offsets.size == 5 and op.rest_op is None
    x, info = _runs(lambda c: TS.conjugate_gradient(
        op, b, tol=1e-6, maxiter=2000, check_every=c))
    want = np.linalg.solve(dense, b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(xj), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(x), want, rtol=2e-3, atol=2e-3)
    _agree(x, xj, "cg/dia")
    _iters_agree(info, ij)
    assert int(info.iterations) > 0


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "jacobi", "power",
                                    "pagerank"])
def test_masked_iterations_stop_at_maxiter(solver):
    """A cap below convergence stops every solver at exactly ``maxiter``,
    whatever the block size: the masked steps past it change nothing."""
    csr, dense = _laplacian_csr(10)
    op = build_operator(_port(csr), dtype="float32", device="cpu")
    b = np.random.RandomState(6).uniform(-1, 1, csr.num_rows).astype(
        np.float32)
    diag = np.diag(dense).astype(np.float32)
    calls = {
        "cg": lambda c: TS.conjugate_gradient(op, b, tol=1e-12, maxiter=5,
                                              check_every=c),
        "bicgstab": lambda c: TS.bicgstab(op, b, tol=1e-12, maxiter=5,
                                          check_every=c),
        "jacobi": lambda c: TS.jacobi(op, diag, b, tol=1e-12, maxiter=5,
                                      check_every=c),
        "power": lambda c: TS.power_iteration(op, v0=b, tol=0.0, maxiter=5,
                                              check_every=c)[1:],
        "pagerank": lambda c: TS.pagerank(op, tol=0.0, maxiter=5,
                                          check_every=c),
    }
    runs = [calls[solver](c) for c in (1, 3, 16)]
    for x, info in runs:
        assert int(info.iterations) == 5
        assert torch.equal(x, runs[0][0])
    assert [info.host_reads for _, info in runs] == [5, 2, 1]
