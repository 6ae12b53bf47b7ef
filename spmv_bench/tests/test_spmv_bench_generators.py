"""The generators at a tiny size: shape, nonzeros and repeatability."""

import numpy as np
import pytest
import torch

from spmv_bench.generators import derive_seed, rmat, stencil27

RMAT = {"scale": 9, "nnz": 5000, "a": 0.57, "b": 0.19, "c": 0.19,
        "values": [-1.0, 1.0]}
SEED = 2 ** 31 + 977


def test_rmat_shape_and_nnz():
    csr = rmat.generate(RMAT, SEED, "cpu")
    n = 1 << RMAT["scale"]
    assert csr["num_rows"] == csr["num_cols"] == n
    off = csr["row_offsets"]
    assert off.dtype == torch.int64 and off.shape == (n + 1,)
    assert int(off[0]) == 0 and int(off[-1]) == RMAT["nnz"]
    assert bool((off[1:] >= off[:-1]).all())
    cols = csr["col_indices"]
    assert cols.dtype == torch.int32 and cols.numel() == RMAT["nnz"]
    assert int(cols.min()) >= 0 and int(cols.max()) < n
    vals = csr["values"]
    assert vals.dtype == torch.float64
    assert float(vals.min()) >= -1.0 and float(vals.max()) < 1.0
    # columns sorted within each row
    rows = torch.repeat_interleave(torch.arange(n), off[1:] - off[:-1])
    key = rows * n + cols.long()
    assert bool((key[1:] >= key[:-1]).all())


def test_rmat_is_power_law():
    csr = rmat.generate(RMAT, SEED, "cpu")
    lengths = (csr["row_offsets"][1:] - csr["row_offsets"][:-1]).double()
    # quadrant a's weight piles rows near 0: the longest row is many
    # times the mean
    assert float(lengths.max()) > 10 * float(lengths.mean())


def test_rmat_relabels_the_vertices():
    csr = rmat.generate(RMAT, SEED, "cpu")
    lengths = csr["row_offsets"][1:] - csr["row_offsets"][:-1]
    # without the relabelling the longest rows are the ids with the
    # fewest bits set: 0, then the powers of two
    longest = torch.topk(lengths, 8).indices.tolist()
    few_bits = [i for i in longest if bin(i).count("1") <= 1]
    assert len(few_bits) < 4, longest
    hot = torch.bincount(csr["col_indices"].long(),
                         minlength=csr["num_cols"])
    assert int(hot.argmax()) != 0


def test_rmat_repeats_from_the_seed():
    a = rmat.generate(RMAT, SEED, "cpu")
    b = rmat.generate(RMAT, SEED, "cpu")
    c = rmat.generate(RMAT, SEED + 1, "cpu")
    for key in ("row_offsets", "col_indices", "values"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["values"], c["values"])


@pytest.mark.parametrize("w", [3, 5, 8])
def test_stencil_nnz_symmetry_and_row_sums(w):
    params = {"nx": w, "ny": w, "nz": w, "diagonal": 26.0,
              "off_diagonal": -1.0}
    csr = stencil27.generate(params, SEED, "cpu")
    n = w ** 3
    off = csr["row_offsets"]
    assert csr["num_rows"] == n and int(off[-1]) == (3 * w - 2) ** 3
    lengths = (off[1:] - off[:-1]).numpy()
    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n), lengths)
    dense[rows, csr["col_indices"].numpy()] = csr["values"].numpy()
    np.testing.assert_array_equal(dense, dense.T)
    np.testing.assert_array_equal(np.diag(dense), 26.0)
    np.testing.assert_array_equal(dense.sum(1), 26.0 - (lengths - 1))


def test_stencil_does_not_depend_on_the_seed():
    params = {"nx": 4, "ny": 3, "nz": 5, "diagonal": 26.0,
              "off_diagonal": -1.0}
    a = stencil27.generate(params, 1, "cpu")
    b = stencil27.generate(params, 2 ** 33, "cpu")
    assert int(a["row_offsets"][-1]) == 10 * 7 * 13
    for key in ("row_offsets", "col_indices", "values"):
        assert torch.equal(a[key], b[key])


def test_derive_seed_takes_large_seeds():
    seeds = {derive_seed(s, "x") for s in (0, 2 ** 31 + 5, 2 ** 40, -3)}
    assert len(seeds) == 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert derive_seed(7, "a") != derive_seed(7, "b")
