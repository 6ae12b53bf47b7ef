"""float64 long-row accumulation audit of the port (the twin of
tests/test_fp64_audit.py).

One row of n uniform (0, 1) values times x in (0.5, 1.5): every term is
positive, so the sum's condition number is 1 and any summation order is
within gamma_n = n u / (1 - n u) of the exact sum, u = 2^-53 (Higham,
Accuracy and Stability of Numerical Algorithms, eq. 4.4).  The port
computes float64 natively, so the row is held to a float64-class bound,
2 gamma_n (its own error and that of the float64 NumPy dot it is compared
with), and, as the JAX package's double-single route is, to 64 * 2^-24.  Here the
plain version runs (device="cpu"); chip_smoke.py runs the 4,000,000-nonzero
row through the kernel on the card.
"""

import numpy as np
import pytest

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.operator import build_operator

JAX_BOUND = 64 * 2.0 ** -24


def _single_row_csr(n, seed=0):
    rs = np.random.RandomState(seed)
    values = rs.uniform(0.0, 1.0, n)
    cols = np.arange(n, dtype=np.int32)
    return CsrMatrix(1, n, np.array([0, n], dtype=np.int32), cols, values)


def gamma(n, u=2.0 ** -53):
    return n * u / (1 - n * u)


@pytest.mark.parametrize("tile_items", [None, 1024, 4096])
@pytest.mark.parametrize("n", [200_000])
def test_fp64_long_row_error_bound(n, tile_items):
    csr = _single_row_csr(n)
    x = np.random.RandomState(1).uniform(0.5, 1.5, n)
    gold = float(np.dot(csr.values.astype(np.float64), x))
    op = build_operator(csr, dtype="float64", tile_items=tile_items,
                        device="cpu")
    y = op(x)
    assert y.dtype.is_floating_point and y.element_size() == 8
    rel = abs(float(y[0]) - gold) / abs(gold)
    assert rel < JAX_BOUND, f"rel err {rel:.3e}"
    assert rel <= 2 * gamma(n), f"rel err {rel:.3e} > 2 gamma_n"
