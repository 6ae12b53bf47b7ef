"""The frozen byte and operation models against hand counts, and the
roofline share read from a trace."""

from types import SimpleNamespace

import pytest

from spmv_bench import roofline
from spmv_bench.trace import Trace

H100 = "NVIDIA H100 80GB HBM3"


def test_spmv_bytes_by_hand():
    # 3 rows, 4 columns, 5 nonzeros, float64, with y_in:
    # values 5*8 + columns 5*4 + row ends 3*4 + x 4*8 + y_in 3*8 + y 3*8
    assert roofline.product_bytes(3, 4, 5, 1, "float64", True) == \
        40 + 20 + 12 + 32 + 24 + 24
    # without y_in, float32
    assert roofline.product_bytes(3, 4, 5, 1, "float32", False) == \
        20 + 20 + 12 + 16 + 12


def test_spmm_bytes_by_hand():
    # k = 2: X 4*2*8, Y_in and Y 3*2*8 each
    assert roofline.product_bytes(3, 4, 5, 2, "float64", True) == \
        40 + 20 + 12 + 64 + 48 + 48


def test_cells_bytes():
    kron = roofline.product_bytes(2 ** 21, 2 ** 21, 182_082_942, 1,
                                  "float64", True)
    assert kron == 182_082_942 * 12 + 2 ** 21 * (4 + 8 * 3)
    assert kron / 3.35e12 == pytest.approx(0.670e-3, rel=1e-3)
    k8 = roofline.product_bytes(104 ** 3, 104 ** 3, 310 ** 3, 8,
                                "float64", True)
    assert k8 / 1e6 == pytest.approx(578.0, rel=1e-3)


def test_least_time_is_bytes_bound_and_unknown_card_gives_none():
    t, by = roofline.least_seconds(2 ** 21, 2 ** 21, 182_082_942, 1,
                                   "float64", True, H100)
    assert by == "bytes"
    assert roofline.least_seconds(10, 10, 10, 1, "float64", False,
                                  "some other card") is None
    assert roofline.product_flops(3, 5, 2, True) == 2 * 5 * 2 + 3 * 2 * 3


def _run(trace, k=1, beta=1.0, products=2, dtype="float64"):
    cell = SimpleNamespace(problem={"num_rows": 100, "num_cols": 100,
                                    "nnz": 1000, "dtype": dtype},
                           traffic={"k": k, "beta": beta})
    return SimpleNamespace(trace=trace, cell=cell, device_name=H100,
                           loop=SimpleNamespace(traced_products=products))


def _launches(name, times, t0=0.1, gap=0.01):
    """A trace of one launch of ``name`` for each time, back to back."""
    device, t = [], t0
    for dt in times:
        device.append((name, t, t + dt))
        t += dt + gap
    return Trace(start=0.0, end=t + 1.0, device=device)


def test_kernel_share_from_a_trace():
    least, _ = roofline.least_seconds(100, 100, 1000, 1, "float64", True,
                                      H100)
    trace = Trace(start=0.0, end=1.0, device=[
        ("merge_tile_kernel<double>", 0.1, 0.1 + 4 * least),
        ("merge_tile_kernel<double>", 0.5, 0.5 + 4 * least),
        ("merge_tile_mm_kernel<double>", 0.7, 0.8)])
    assert roofline.kernel_share_pct(_run(trace), "merge_tile_kernel") == \
        pytest.approx(25.0)
    assert roofline.kernel_share_pct(_run(trace), "absent") is None
    assert roofline.kernel_share_pct(_run(None), "merge_tile_kernel") is None
    assert roofline.kernel_share_pct(_run(trace, products=0),
                                     "merge_tile_kernel") is None


def test_at_k_1_the_share_is_the_launch_formula():
    """One launch a product: the least time of one product over the mean
    time a launch, as the share was read before it counted products."""
    least, _ = roofline.least_seconds(100, 100, 1000, 1, "float64", True,
                                      H100)
    times = [least * f for f in (1.3, 2.9, 1.7, 4.1, 2.2, 3.3, 1.1)]
    trace = _launches("merge_tile_kernel<double>", times)
    launches, seconds = trace.kernel("merge_tile_kernel")
    by_launch = 100.0 * least / (seconds / launches)
    share = roofline.kernel_share_pct(_run(trace, products=len(times)),
                                      "merge_tile_kernel")
    assert share == pytest.approx(by_launch, rel=1e-12)
    assert 0 < share < 100


@pytest.mark.parametrize("k,blocks", [(256, [64, 64, 64, 64]),
                                      (130, [64, 64, 2])])
def test_wide_k_counts_a_product_over_its_launches(k, blocks):
    """K1m runs k above 64 as a launch a block of 64 columns: a product
    is their sum, and one product's least time is read over it."""
    least, by = roofline.least_seconds(100, 100, 1000, k, "float32", False,
                                       H100)
    assert by == "bytes"
    # each launch as slow as its own block's bound, rereading A
    times = [roofline.least_seconds(100, 100, 1000, kw, "float32", False,
                                    H100)[0] for kw in blocks] * 3
    trace = _launches("merge_tile_mm_kernel<float>", times)
    share = roofline.kernel_share_pct(
        _run(trace, k=k, beta=0.0, products=3, dtype="float32"),
        "merge_tile_mm_kernel")
    # the trace's clock rounds each time in its last bits
    assert share == pytest.approx(100.0 * 3 * least / sum(times), rel=1e-9)
    assert share < 100
    # by launch the same trace would read several times too high
    by_launch = 100.0 * least / (sum(times) / len(times))
    assert by_launch > 100
    assert by_launch / share == pytest.approx(len(blocks), rel=1e-9)


def test_trace_busy_idle_and_breakdown():
    trace = Trace(start=0.0, end=10.0,
                  device=[("k1", 1.0, 3.0), ("copy", 2.0, 4.0),
                          ("k1", 6.0, 7.0), ("late", 9.5, 12.0)],
                  host=[("sync", 4.0, 6.0), ("outer", 0.0, 10.0)])
    assert trace.busy_s() == pytest.approx(3.0 + 1.0 + 0.5)
    assert trace.kernel("k1") == (2, pytest.approx(3.0))
    assert trace.device_ops()[0] == ["k1", pytest.approx(3.0)]
    gaps = trace.idle_gaps()
    assert gaps[0] == ["outer", pytest.approx(2.5)]
    assert gaps[1] == ["sync", pytest.approx(2.0)]
