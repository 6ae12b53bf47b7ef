"""The port's partition (merge_spmv_tpu_torch/parallel/partition.py)
against the JAX package's: every array bit for bit, and the x-sharding
decision, on the matrices of tests/test_distributed.py at S = 1, 2, 4, 8.
"""

import numpy as np
import pytest

from merge_spmv_tpu.formats.coo import CooMatrix
from merge_spmv_tpu.formats.csr import CsrMatrix
from merge_spmv_tpu.parallel.partition import partition_csr as jax_partition
from merge_spmv_tpu_torch.formats.csr import CsrMatrix as TCsr
from merge_spmv_tpu_torch.parallel.partition import partition_csr

# tests/test_distributed.py:24-33
MATRICES = {
    "grid2d": lambda: CooMatrix.grid2d(15),
    "wheel": lambda: CooMatrix.wheel(500),
    "powerlaw": lambda: CooMatrix.random_powerlaw(400, 300, 3000, seed=2),
    "empty_rows": lambda: CooMatrix(350, 40, rows=[10, 300],
                                    cols=[0, 39], vals=[1.0, 2.0]),
    "giant_row": lambda: CooMatrix(9, 4000,
                                   rows=np.zeros(4000, np.int64),
                                   cols=np.arange(4000),
                                   vals=np.ones(4000)),
}


def _banded(n, half_bw, deg, seed):
    """tests/test_distributed.py::_banded: selects halo mode at S = 8."""
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + r.randint(-half_bw, half_bw + 1, rows.size),
                   0, n - 1)
    return CooMatrix(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


EXTRA = {
    "banded": lambda: _banded(4096, 300, 4, 7),
    "scattered": lambda: CooMatrix.random_uniform(2000, 2000, 4, seed=8),
    "grid2d40": lambda: CooMatrix.grid2d(40),
}

FIELDS = ("num_shards", "num_rows", "num_cols", "num_nonzeros", "rows_max",
          "nnz_max", "x_mode", "cpad", "halo", "local_x_width")
ARRAYS = ("values", "col_indices", "rowends_local", "meta", "row_starts")


def _csr(name):
    gen = MATRICES.get(name) or EXTRA[name]
    csr = CsrMatrix.from_coo(gen())
    csr.values = np.random.RandomState(0).uniform(0.1, 1.0,
                                                  csr.num_nonzeros)
    return csr


def _port(csr):
    return TCsr.from_arrays(csr.num_rows, csr.num_cols, csr.row_offsets,
                            csr.col_indices, csr.values)


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _check(jp, tp, context):
    for f in FIELDS:
        assert getattr(tp, f) == getattr(jp, f), (context, f)
    for a in ARRAYS:
        assert _bit_equal(getattr(tp, a), getattr(jp, a)), (context, a)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(MATRICES) + sorted(EXTRA))
def test_partition_bit_equal(name, num_shards):
    csr = _csr(name)
    for dtype in (np.float32, np.float64):
        for halo in (True, False):
            jp = jax_partition(csr, num_shards, dtype=dtype,
                               allow_halo_x=halo)
            tp = partition_csr(_port(csr), num_shards, dtype=dtype,
                               allow_halo_x=halo)
            _check(jp, tp, f"{name}/{num_shards}/{np.dtype(dtype)}/{halo}")
    x = np.random.RandomState(1).uniform(-1, 1, csr.num_cols).astype(
        np.float32)
    assert _bit_equal(tp.shard_x(x), jp.shard_x(x))


def test_halo_and_replicate_decisions():
    """The banded matrix takes halo mode at S = 8 (halo <= cpad, both
    multiples of 128); the scattered one replicates; the choice is JAX's
    on every matrix and S."""
    banded = partition_csr(_port(_csr("banded")), 8)
    assert banded.x_mode == "halo"
    assert banded.halo <= banded.cpad
    assert banded.halo % 128 == 0 and banded.cpad % 128 == 0
    assert banded.local_x_width == banded.cpad + 2 * banded.halo
    assert partition_csr(_port(_csr("scattered")), 8).x_mode == "replicate"
    assert partition_csr(_port(_csr("banded")), 8,
                         allow_halo_x=False).x_mode == "replicate"
    modes = {(name, s): partition_csr(_port(_csr(name)), s).x_mode
             for name in sorted(MATRICES) + sorted(EXTRA)
             for s in (1, 2, 4, 8)}
    assert "halo" in modes.values() and "replicate" in modes.values()
    for (name, s), mode in modes.items():
        assert mode == jax_partition(_csr(name), s).x_mode, (name, s)


def test_carry_dst_precomputed_giant_row():
    """All shares inside a giant row route their carry straight to the
    completing share (no chain): dst is static and JAX's."""
    csr = _csr("giant_row")
    part = partition_csr(_port(csr), 8)
    dst, owned = part.meta[:, 5], part.meta[:, 4]
    spanning = owned < part.meta[:, 2]
    assert (dst[spanning][:-1] >= np.arange(8)[spanning][:-1]).all()
    zero_owned = np.nonzero(owned == 0)[0]
    assert len(zero_owned)
    assert (dst[zero_owned] == dst[zero_owned[0]]).all()
    np.testing.assert_array_equal(dst, jax_partition(csr, 8).meta[:, 5])


def test_balanced_merge_work_and_nnz_conserved():
    """tests/test_distributed.py::TestPartition on the port."""
    csr = _csr("wheel")
    part = partition_csr(_port(csr), 8)
    work = np.diff(part.row_starts.astype(np.int64)) + \
        np.diff(np.concatenate([[0], np.cumsum(part.meta[:, 3])]))
    per = -(-(csr.num_rows + csr.num_nonzeros) // 8)
    assert (work <= per).all()
    part = partition_csr(_port(_csr("powerlaw")), 8)
    assert part.meta[:, 3].sum() == part.num_nonzeros


def test_to_device_gives_one_rank_share():
    part = partition_csr(_port(_csr("powerlaw")), 4)
    for rank in range(4):
        vals, cols, rowends, meta = part.to_device(rank, device="cpu")
        for got, want in ((vals, part.values), (cols, part.col_indices),
                          (rowends, part.rowends_local), (meta, part.meta)):
            assert got.device.type == "cpu"
            assert _bit_equal(got.numpy(), want[rank])
