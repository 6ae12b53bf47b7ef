"""The gather-rate probe (tools/gather_rate.py) on the CPU: the wrapper
runs the plain version for CPU tensors and counts no launch, the plain
version sums in k order, the sector count and the gather bound are the
arithmetic their docstrings state, and measuring needs the card.  The
probe has no counterpart in the JAX package; the kernel is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
Also the text substitutions of the mutation check that breaks the merge
kernel's tail (tools/tail_mutants.py).
"""

import numpy as np
import pytest
import torch

from merge_spmv_tpu_torch.tools import gather_rate as GR


@pytest.mark.parametrize("count,threads", [(0, 256), (1000, 256),
                                           (100_003, 768)])
def test_cpu_gather_sum_is_the_plain_version(count, threads):
    rs = np.random.RandomState(count)
    x = torch.from_numpy(rs.uniform(-1, 1, 777).astype(np.float32))
    idx = torch.from_numpy(rs.randint(0, 777, count).astype(np.int32))
    GR.reset_launches()
    got = GR.gather_sum(x, idx, threads // GR.THREADS)
    assert GR.LAUNCHES == {"gather_rate": 0, "gather_rows": 0}
    assert got.shape == (threads,)
    # out[t] = sum over k of x[idx[t + k * threads]], k in order
    want = np.zeros(threads, np.float32)
    xs, ids = x.numpy(), idx.numpy()
    for k in range(0, count, threads):
        seg = ids[k:k + threads]
        want[:seg.size] += xs[seg]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("row_floats", GR.ROW_FLOATS)
@pytest.mark.parametrize("count", [0, 1000, 20_003])
def test_cpu_gather_rows_is_the_plain_version(count, row_floats):
    """The rows class on CPU tensors: out[g, :] = sum over j of
    X[idx[g + j * G], :], G = threads * 4 / row_floats, j in order;
    thread t's four floats at [4 t, 4 t + 4)."""
    rs = np.random.RandomState(count + row_floats)
    X = torch.from_numpy(rs.uniform(-1, 1, (333, row_floats)).astype(
        np.float32))
    idx = torch.from_numpy(rs.randint(0, 333, count).astype(np.int32))
    GR.reset_launches()
    got = GR.gather_rows(X, idx, 2)
    assert not any(GR.LAUNCHES.values())
    G = 2 * GR.THREADS * 4 // row_floats
    want = np.zeros((G, row_floats), np.float32)
    xs, ids = X.numpy(), idx.numpy()
    for j in range(0, count, G):
        seg = ids[j:j + G]
        want[:seg.size] += xs[seg]
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1))
    with pytest.raises(ValueError):
        GR.gather_rows(X[:, :3], idx, 2)


def test_rows_gather_bound_arithmetic():
    # 1e9 requests of 128 B at 6400 GB/s, plus 3.35e9 B at 3350 GB/s
    assert GR.rows_gather_bound_ms(10**9, 128, 6400.0, 3_350_000_000,
                                   3350.0) == pytest.approx(21.0)
    with pytest.raises(RuntimeError, match="on the card"):
        GR.measure_rows(torch.zeros(4, dtype=torch.int32), 4, device="cpu")


def test_warp_sectors_counts_each_request():
    """A request is 32 consecutive nonzeros; its sectors are 32 bytes of
    x, 8 float32 or 4 float64 columns."""
    cols = torch.cat([torch.arange(32), torch.arange(32) * 8,
                      torch.zeros(32, dtype=torch.int64)]).int()
    assert GR.warp_sectors(cols) == 4 + 32 + 1
    assert GR.warp_sectors(cols, "float64") == 8 + 32 + 1
    assert GR.warp_sectors(torch.zeros(0, dtype=torch.int32)) == 0


def test_gather_bound_arithmetic():
    # 1e9 sectors of 32 B at 3200 GB/s, plus 3.35e9 B at 3350 GB/s
    assert GR.gather_bound_ms(10**9, 3_350_000_000, 3200.0, 3350.0) \
        == pytest.approx(11.0)


def test_measuring_needs_the_card():
    with pytest.raises(RuntimeError, match="on the card"):
        GR.measure(device="cpu")


def test_tail_mutants_break_the_tail_once_each():
    from merge_spmv_tpu_torch.tools import tail_mutants as TM
    from merge_spmv_tpu_torch.utils.cuda_build import CSRC_DIR
    src = (CSRC_DIR / "merge_csrmv.cu").read_text()
    for old, new in TM.MUTANTS.values():
        assert src.count(old) == 1 and src.replace(old, new) != src
