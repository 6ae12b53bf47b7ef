"""The port's host data layer held against the JAX package's: the same
generators, .mtx text and arrays give identical results.

Both packages are imported here (the port never imports the JAX one); data
passes between them as numpy arrays.
"""

import numpy as np
import pytest
import torch

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
import merge_spmv_tpu.utils.compare as jcmp
import merge_spmv_tpu.utils.rng as jrng
import merge_spmv_tpu_torch.formats.coo as tcoo
import merge_spmv_tpu_torch.formats.csr as tcsr
import merge_spmv_tpu_torch.utils.compare as tcmp
import merge_spmv_tpu_torch.utils.rng as trng

GENERATORS = {
    "dense": ("dense", (7, 9)),
    "wheel": ("wheel", (50,)),
    "grid2d": ("grid2d", (6,)),
    "grid2d_loop": ("grid2d", (5, True)),
    "grid3d": ("grid3d", (4,)),
    "uniform": ("random_uniform", (60, 40, 5, 3)),
    "powerlaw": ("random_powerlaw", (200, 150, 1500, 1.3, 2)),
}


def _pair(name):
    method, args = GENERATORS[name]
    return (getattr(jcoo.CooMatrix, method)(*args),
            getattr(tcoo.CooMatrix, method)(*args))


def _same_csr(a, b):
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)
    np.testing.assert_array_equal(a.row_offsets, b.row_offsets)
    np.testing.assert_array_equal(a.col_indices, b.col_indices)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.values.dtype == b.values.dtype


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_identical(name):
    j, t = _pair(name)
    assert (j.num_rows, j.num_cols) == (t.num_rows, t.num_cols)
    for field in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(j, field), getattr(t, field))
    _same_csr(jcsr.CsrMatrix.from_coo(j), tcsr.CsrMatrix.from_coo(t))


MTX = {
    "general": """%%MatrixMarket matrix coordinate real general
% a comment
3 4 5
1 1 1.5
1 2 2.5
2 4 -3.0
3 1 4.0
3 1 0.5
""",
    "symmetric": """%%MatrixMarket matrix coordinate real symmetric
3 3 3
1 1 1.0
2 1 2.0
3 2 3.0
""",
    "skew": """%%MatrixMarket matrix coordinate real skew-symmetric
2 2 1
2 1 5.0
""",
    "pattern": """%%MatrixMarket matrix coordinate pattern general
2 2 2
1 2
2 1
""",
    "array": """%%MatrixMarket matrix array real general
2 2
1.0
2.0
3.0
4.0
""",
    "ragged": """%%MatrixMarket matrix coordinate real general
3 3 3
1 1 2.0
2 2
3 3 4.0
""",
}


@pytest.mark.parametrize("name", sorted(MTX))
def test_market_parse_identical(name, tmp_path):
    path = tmp_path / f"{name}.mtx"
    path.write_text(MTX[name])
    j = jcoo.CooMatrix.from_market(str(path), default_value=7.0,
                                   use_native=False)
    t = tcoo.CooMatrix.from_market(str(path), default_value=7.0,
                                   use_native=False)
    for field in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(j, field), getattr(t, field))
    _same_csr(jcsr.CsrMatrix.from_market(str(path)),
              tcsr.CsrMatrix.from_market(str(path)))


def test_market_roundtrip(tmp_path):
    coo = tcoo.CooMatrix.grid2d(5)
    path = str(tmp_path / "rt.mtx")
    coo.to_market(path)
    back = tcoo.CooMatrix.from_market(path)
    np.testing.assert_allclose(tcsr.CsrMatrix.from_coo(back).to_dense(),
                               tcsr.CsrMatrix.from_coo(coo).to_dense())


def test_market_rejects_short_file(tmp_path):
    path = tmp_path / "short.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "3 3 4\n1 1 1.0\n")
    with pytest.raises(ValueError, match="expected 4 entries"):
        tcoo.CooMatrix.from_market(str(path))


def test_from_arrays_carries_jax_matrix():
    j = jcsr.CsrMatrix.from_coo(jcoo.CooMatrix.random_powerlaw(
        120, 90, 700, seed=5))
    t = tcsr.CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                                   j.col_indices, j.values)
    _same_csr(j, t)
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, j.num_cols)
    y_in = rs.uniform(-1, 1, j.num_rows)
    np.testing.assert_array_equal(j.spmv_gold(x, y_in, 2.0, 0.5),
                                  t.spmv_gold(x, y_in, 2.0, 0.5))
    np.testing.assert_array_equal(j.spmv_abs_bound(x), t.spmv_abs_bound(x))
    X = np.random.RandomState(2).uniform(-1, 1, (j.num_cols, 3))
    np.testing.assert_array_equal(j.spmm_gold(X), t.spmm_gold(X))


def test_stats_and_histogram_identical():
    j = jcsr.CsrMatrix.from_coo(jcoo.CooMatrix.wheel(100))
    t = tcsr.CsrMatrix.from_coo(tcoo.CooMatrix.wheel(100))
    assert j.stats().as_dict() == t.stats().as_dict()
    jc, jm = j.row_length_histogram()
    tc, tm = t.row_length_histogram()
    np.testing.assert_array_equal(jc, tc)
    assert jm == tm


def test_to_device_returns_torch_arrays():
    csr = tcsr.CsrMatrix.from_coo(tcoo.CooMatrix.grid2d(4))
    v, re_, ci = csr.to_device(dtype="float32", device="cpu")
    assert v.dtype == torch.float32 and v.device.type == "cpu"
    assert re_.dtype == torch.int32 and ci.dtype == torch.int32
    np.testing.assert_array_equal(re_.numpy(), csr.row_end_offsets)
    np.testing.assert_array_equal(ci.numpy(), csr.col_indices)
    v16, _, _ = csr.to_device(dtype=torch.bfloat16, device="cpu")
    assert v16.dtype == torch.bfloat16


def test_to_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    csr = tcsr.CsrMatrix.from_coo(tcoo.CooMatrix.grid2d(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        csr.to_device()


@pytest.mark.parametrize("seed", range(4))
def test_compare_results_identical(seed):
    rs = np.random.RandomState(seed)
    ref = rs.uniform(-1, 1, 500).astype(np.float32)
    got = ref.copy()
    got[rs.randint(0, 500, 3)] += rs.uniform(-1e-3, 1e-3, 3).astype(
        np.float32) * (seed % 2)
    bound = np.abs(ref) * rs.uniform(0, 2)
    assert (jcmp.compare_results(got, ref, verbose=False, abs_bound=bound)
            == tcmp.compare_results(got, ref, verbose=False,
                                    abs_bound=bound))
    np.testing.assert_array_equal(jcmp.ulp_distance(got, ref),
                                  tcmp.ulp_distance(got, ref))


def test_rng_helpers_identical():
    for kw in ({"entropy_reduction": 2, "seed": 1},
               {"begin_bit": 4, "end_bit": 12, "seed": 2},
               {"entropy_reduction": -1}):
        np.testing.assert_array_equal(jrng.random_bits((64,), **kw),
                                      trng.random_bits((64,), **kw))
    np.testing.assert_array_equal(
        jrng.random_values((50,), np.float32, 2.0, 3.0, seed=3),
        trng.random_values((50,), np.float32, 2.0, 3.0, seed=3))
