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
    u = reference.unit_roundoff("float64")
    assert reference.product_error(kron, y, x, b, 0.3, 1.0, y, u) == 0.0
    worse = y.clone()
    worse[0] += 1e-9
    assert reference.product_error(kron, worse, x, b, 0.3, 1.0, y, u) > 100
    worse[1] = float("nan")
    assert reference.product_error(kron, worse, x, b, 0.3, 1.0, y, u) == \
        float("inf")


def test_unit_roundoff_follows_the_dtype():
    assert reference.unit_roundoff("float64") == 2.0 ** -53
    assert reference.unit_roundoff("float32") == 2.0 ** -24


@pytest.mark.parametrize("k,block", [(1, 2 ** 24), (64, 2 ** 18),
                                     (256, 2 ** 16), (2 ** 25, 1)])
def test_blocks_gather_at_most_block_elements(k, block):
    assert reference.block_nonzeros(k) == block


@pytest.mark.parametrize("k", [1, 64, 256])
def test_blocked_product_equals_one_unblocked_index_add(kron, monkeypatch,
                                                        k):
    """Bit for bit, with BLOCK cut so that every k takes several blocks
    of BLOCK // k nonzeros."""
    monkeypatch.setattr(reference, "BLOCK", 1 << 10)
    nnz = kron["values"].numel()
    x = torch.rand((kron["num_cols"],) if k == 1 else (kron["num_cols"], k),
                   dtype=torch.float64, generator=torch.Generator()
                   .manual_seed(k))
    sizes, index_add = [], torch.Tensor.index_add_

    def counting(self, dim, index, source):
        sizes.append(index.numel())
        return index_add(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_add_", counting)
    y = reference.product(kron, x)
    monkeypatch.undo()
    per = (1 << 10) // k
    assert sizes == [min(per, nnz - s) for s in range(0, nnz, per)]
    assert len(sizes) > 1
    rows = torch.repeat_interleave(torch.arange(kron["num_rows"]),
                                   reference.row_lengths(kron))
    vals = kron["values"] if k == 1 else kron["values"][:, None]
    want = torch.zeros_like(y).index_add_(
        0, rows, vals * x[kron["col_indices"].long()])
    assert torch.equal(y, want)


def test_float32_product_reads_order_one_and_bfloat16_about_2_16_more():
    """The same float32 product, then rounded through bfloat16, against
    the float64 reference in float32's unit roundoff: rows of 1 to 3
    positive terms, so the error is one rounding of y either way."""
    n = 4000
    gen = torch.Generator().manual_seed(5)
    lengths = torch.randint(1, 4, (n,), generator=gen)
    offsets = torch.zeros(n + 1, dtype=torch.int64)
    torch.cumsum(lengths, 0, out=offsets[1:])
    nnz = int(offsets[-1])
    csr = {"num_rows": n, "num_cols": n, "row_offsets": offsets,
           "col_indices": torch.randint(0, n, (nnz,), generator=gen,
                                        dtype=torch.int32),
           "values": torch.rand(nnz, dtype=torch.float64, generator=gen)
           .float().double()}
    x = torch.rand(n, dtype=torch.float64, generator=gen).float().double()
    y_ref = reference.affine(csr, x, None, 1.0, 0.0)
    u = reference.unit_roundoff("float32")
    y32 = reference.affine(csr, x, None, 1.0, 0.0, torch.float32).float()
    f32 = reference.product_error(csr, y32, x, None, 1.0, 0.0, y_ref, u)
    bf16 = reference.product_error(csr, y32.bfloat16(), x, None, 1.0, 0.0,
                                   y_ref, u)
    assert 0.05 < f32 <= 1.0
    assert 2 ** 16 / 4 < bf16 / f32 < 2 ** 16 * 4


def test_relative_error():
    x = torch.tensor([1.0, -2.0, 4.0], dtype=torch.float64)
    assert reference.relative_error(x, x) == 0.0
    assert reference.relative_error(x + 1e-3, x) == pytest.approx(2.5e-4)
    assert reference.relative_error(x * float("nan"), x) == float("inf")


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_bfloat16_product_runs_where_the_control_runs(kron, device):
    """The control of a float32 configuration sums in bfloat16 by
    ``index_add_``: it runs, and lands within bfloat16's rounding."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    csr = {k: v.to(device) if torch.is_tensor(v) else v
           for k, v in kron.items()}
    x = torch.rand(kron["num_cols"], 8, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3)).to(device)
    y = reference.product(csr, x, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    want = reference.product(csr, x)
    scale = reference.product(csr, x, absolute=True)
    lengths = reference.row_lengths(csr)[:, None].double()
    assert bool(((y.double() - want).abs()
                 <= (lengths + 2) * 2.0 ** -8 * scale).all())
    assert not torch.equal(y.double(), want)
