"""The plain reference against dense NumPy at a tiny size."""

import numpy as np
import pytest
import torch

from spmv_bench import reference
from spmv_bench.generators import rmat, stencil27

SEED = 2 ** 31 + 31


def dense(csr):
    n = csr["num_rows"]
    lengths = (csr["row_offsets"][1:] - csr["row_offsets"][:-1]).numpy()
    a = np.zeros((n, csr["num_cols"]))
    rows = np.repeat(np.arange(n), lengths)
    np.add.at(a, (rows, csr["col_indices"].numpy()), csr["values"].numpy())
    return a


@pytest.fixture(scope="module")
def kron():
    return rmat.generate({"scale": 8, "nnz": 3000, "a": 0.57, "b": 0.19,
                          "c": 0.19, "values": [-1.0, 1.0]}, SEED, "cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_affine_matches_dense(kron, monkeypatch, k):
    monkeypatch.setattr(reference, "BLOCK", 700)   # several blocks
    a = dense(kron)
    rng = np.random.default_rng(1)
    shape = (a.shape[1],) if k == 1 else (a.shape[1], k)
    x, y_in = rng.uniform(-1, 1, shape), rng.uniform(-1, 1, shape)
    y = reference.affine(kron, torch.from_numpy(x), torch.from_numpy(y_in),
                         0.5, 2.0)
    np.testing.assert_allclose(y.numpy(), 0.5 * a @ x + 2.0 * y_in,
                               rtol=1e-12, atol=1e-12)
    y32 = reference.affine(kron, torch.from_numpy(x), None, 1.0, 0.0,
                           torch.float32)
    assert y32.dtype == torch.float64
    np.testing.assert_allclose(y32.numpy(), a @ x, rtol=1e-4, atol=1e-4)


def test_max_row_abs_sum(kron):
    # over the stored values: duplicates count apart, as they are summed
    lengths = (kron["row_offsets"][1:] - kron["row_offsets"][:-1]).numpy()
    rows = np.repeat(np.arange(kron["num_rows"]), lengths)
    sums = np.bincount(rows, np.abs(kron["values"].numpy()),
                       kron["num_rows"])
    assert reference.max_row_abs_sum(kron) == pytest.approx(sums.max(),
                                                            rel=1e-13)


def test_conjugate_gradient_matches_numpy():
    csr = stencil27.generate({"nx": 5, "ny": 4, "nz": 3, "diagonal": 26.0,
                              "off_diagonal": -1.0}, 0, "cpu")
    a = dense(csr)
    b = np.random.default_rng(2).uniform(-1, 1, a.shape[0])
    x, res = reference.conjugate_gradient(csr, torch.from_numpy(b), 7)
    xn, r = np.zeros_like(b), b.copy()
    p, rs = r.copy(), r @ r
    for _ in range(7):
        ap = a @ p
        al = rs / (p @ ap)
        xn, r = xn + al * p, r - al * ap
        rs_n = r @ r
        p, rs = r + rs_n / rs * p, rs_n
    np.testing.assert_allclose(x.numpy(), xn, rtol=1e-10, atol=1e-13)
    assert res == pytest.approx(np.sqrt(rs), rel=1e-8)


def test_product_error_scale(kron):
    x = torch.rand(kron["num_cols"], dtype=torch.float64)
    b = torch.rand(kron["num_rows"], dtype=torch.float64)
    y = reference.affine(kron, x, b, 0.3, 1.0)
    assert reference.product_error(kron, y, x, b, 0.3, 1.0, y) == 0.0
    worse = y.clone()
    worse[0] += 1e-9
    assert reference.product_error(kron, worse, x, b, 0.3, 1.0, y) > 100
    worse[1] = float("nan")
    assert reference.product_error(kron, worse, x, b, 0.3, 1.0, y) == \
        float("inf")


def test_relative_error():
    x = torch.tensor([1.0, -2.0, 4.0], dtype=torch.float64)
    assert reference.relative_error(x, x) == 0.0
    assert reference.relative_error(x + 1e-3, x) == pytest.approx(2.5e-4)
    assert reference.relative_error(x * float("nan"), x) == float("inf")
