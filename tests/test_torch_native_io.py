"""The port's host library (merge_spmv_tpu_torch/csrc/market_io.cpp) held
against the JAX package's data layer — the mirror of tests/test_native_io.py.

The library is built here by g++ into the port's build/ directory (never
native/build/), so these tests depend on neither the TPU package's
library nor its build.  Tolerances: index arrays exactly equal; values
bit-equal (glibc's strtod and NumPy's string conversion both round
correctly; the JAX test's ``assert_allclose`` is checked too); the writer's
bytes equal the Python writer's.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from merge_spmv_tpu.formats import market as jmarket
from merge_spmv_tpu.formats import native_io as jnative
from merge_spmv_tpu.formats.coo import CooMatrix as JCoo
from merge_spmv_tpu.formats.csr import CsrMatrix as JCsr
from merge_spmv_tpu_torch.formats import market, native_io
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.utils import host_build, hostmem

REPO = Path(__file__).resolve().parents[1]

FILES = {
    "general": """%%MatrixMarket matrix coordinate real general
% comment
3 4 4
1 1 0.5
2 3 -1.25
3 4 2.0
1 1 3.0
""",
    "symmetric": """%%MatrixMarket matrix coordinate real symmetric
4 4 4
1 1 1.0
3 1 2.0
4 2 3.0
4 4 4.0
""",
    "skew": """%%MatrixMarket matrix coordinate real skew-symmetric
3 3 2
2 1 5.0
3 2 -1.5
""",
    "pattern": """%%MatrixMarket matrix coordinate pattern general
3 3 3
1 2
2 3
3 1
""",
    "array": """%%MatrixMarket matrix array real general
2 3
1.0
2.0
3.0
4.0
5.0
6.0
""",
    "integer": """%%MatrixMarket matrix coordinate integer general
2 2 2
1 1 7
2 2 -3
""",
}


def _bits_equal(a, b):
    np.testing.assert_allclose(a, b)   # tests/test_native_io.py:92
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


def test_library_is_the_ports_own_build():
    assert native_io.available(), native_io.build_error()
    path = host_build.library_path("market_io")
    assert path.exists() and path.parent == host_build.BUILD_DIR
    assert path.name.startswith("libmarket_io-") and path.suffix == ".so"
    assert "native" not in path.parts
    assert path.parent == REPO / "merge_spmv_tpu_torch" / "build"


def test_warm_heap_is_idempotent(monkeypatch):
    assert hostmem.enable_warm_heap() is True   # glibc
    # a second call touches libc no more
    def no_libc(*a, **k):
        raise AssertionError("mallopt called again")
    monkeypatch.setattr(hostmem.ctypes, "CDLL", no_libc)
    assert hostmem.enable_warm_heap() is True


@pytest.mark.parametrize("name", sorted(FILES))
def test_parser_parity(name, tmp_path):
    """The port's native parser against the JAX package's NumPy parser
    (after a (row, col) lexsort: symmetric expansion interleaves the
    mirrored entries) and, where the JAX package's own library builds,
    against it element for element."""
    path = tmp_path / f"{name}.mtx"
    path.write_text(FILES[name])
    got = native_io.read_market(str(path), default_value=1.0)
    want = jmarket.read_market(str(path), default_value=1.0)
    assert got[0] == want[0] and got[1] == want[1]
    g_r, g_c, g_v = got[2], got[3], got[4]
    w_r, w_c, w_v = want[2], want[3], want[4]
    assert len(g_v) == len(w_v)
    go = np.lexsort((g_c, g_r))
    wo = np.lexsort((w_c, w_r))
    np.testing.assert_array_equal(g_r[go], w_r[wo])
    np.testing.assert_array_equal(g_c[go], w_c[wo])
    _bits_equal(g_v[go], w_v[wo])
    if jnative.available():
        ref = jnative.read_market(str(path), default_value=1.0)
        assert got[:2] == ref[:2]
        for a, b in zip(got[2:], ref[2:]):
            np.testing.assert_array_equal(a, b)
    # the container: from_market's native path gives these arrays
    coo = CooMatrix.from_market(str(path))
    for a, b in zip((coo.rows, coo.cols, coo.vals), got[2:]):
        np.testing.assert_array_equal(a, b)


def test_from_market_falls_back_on_a_rejected_file(tmp_path):
    """A comment line inside the data section: the native parser rejects
    it, the NumPy parser reads it, and from_market returns its arrays."""
    path = tmp_path / "inner_comment.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "3 3 2\n1 1 1.0\n% inner\n3 2 2.0\n")
    with pytest.raises(ValueError):
        native_io.read_market(str(path))
    coo = CooMatrix.from_market(str(path))
    want = jmarket.read_market(str(path))
    for a, b in zip((coo.rows, coo.cols, coo.vals), want[2:]):
        np.testing.assert_array_equal(a, b)


def test_coo_to_csr_parity():
    coo = JCoo.random_powerlaw(500, 400, 5000, seed=7)
    want = JCsr.from_coo(coo, use_native=False)
    ro, ci, vals = native_io.coo_to_csr(coo.num_rows, coo.rows, coo.cols,
                                        coo.vals)
    np.testing.assert_array_equal(ro, want.row_offsets)
    np.testing.assert_array_equal(ci, want.col_indices)
    _bits_equal(vals, want.values)


def test_coo_to_csr_empty_rows_and_duplicates():
    coo = CooMatrix(7, 5, rows=[3, 3, 3, 6], cols=[2, 2, 1, 0],
                    vals=[1.0, 2.0, 3.0, 4.0])
    ro, ci, vals = native_io.coo_to_csr(coo.num_rows, coo.rows, coo.cols,
                                        coo.vals)
    np.testing.assert_array_equal(ro, [0, 0, 0, 0, 3, 3, 3, 4])
    # stable: the duplicate (3,2) pair keeps file order after col sort
    np.testing.assert_array_equal(ci, [1, 2, 2, 0])
    np.testing.assert_array_equal(vals, [3.0, 1.0, 2.0, 4.0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_large_roundtrip_through_from_coo(dtype):
    """Above 2^16 nonzeros from_coo takes the native sort: the JAX NumPy
    path's arrays exactly, in the values' own dtype."""
    coo = CooMatrix.random_uniform(1200, 900, 64, seed=1, dtype=dtype)
    jc = JCoo.random_uniform(1200, 900, 64, seed=1, dtype=dtype)
    assert coo.num_nonzeros > 1 << 16
    native = CsrMatrix.from_coo(coo, use_native=True)
    python = JCsr.from_coo(jc, use_native=False)
    np.testing.assert_array_equal(native.row_offsets, python.row_offsets)
    np.testing.assert_array_equal(native.col_indices, python.col_indices)
    assert native.values.dtype == python.values.dtype == dtype
    np.testing.assert_array_equal(native.values, python.values)


def test_repeated_coordinates_order_in_csr(tmp_path):
    """CSR order differs from the NumPy path's only where a file repeats
    a coordinate: in a general file never; in a symmetric file holding
    both (i, j) and (j, i), the repeated pair's values come in expansion
    order (the native parser mirrors each entry in place)."""
    general = tmp_path / "general.mtx"
    general.write_text("%%MatrixMarket matrix coordinate real general\n"
                       "3 3 5\n2 1 1.0\n1 2 2.0\n2 1 3.0\n3 3 4.0\n"
                       "1 2 5.0\n")
    sym = tmp_path / "sym.mtx"
    sym.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                   "3 3 3\n2 1 1.0\n1 2 2.0\n3 3 4.0\n")
    for path, same_order in ((general, True), (sym, False)):
        a = CsrMatrix.from_coo(CooMatrix.from_market(str(path)))
        b = JCsr.from_coo(JCoo.from_market(str(path), use_native=False),
                          use_native=False)
        np.testing.assert_array_equal(a.row_offsets, b.row_offsets)
        np.testing.assert_array_equal(a.col_indices, b.col_indices)
        if same_order:
            np.testing.assert_array_equal(a.values, b.values)
        else:
            assert not np.array_equal(a.values, b.values)
            ka = np.lexsort((a.values, a.row_ids()))
            kb = np.lexsort((b.values, b.row_ids()))
            np.testing.assert_array_equal(a.values[ka], b.values[kb])


@pytest.mark.parametrize("threads", [1, 4])
def test_stable_sort_does_not_depend_on_threads(threads, tmp_path):
    """__gnu_parallel::stable_sort under OMP_NUM_THREADS=1 and 4: the
    NumPy path's arrays exactly, with many repeated coordinates."""
    rs = np.random.RandomState(5)
    n = 300_000
    rows = rs.randint(0, 500, n).astype(np.int32)
    cols = rs.randint(0, 40, n).astype(np.int32)
    vals = rs.uniform(-1, 1, n)
    np.save(tmp_path / "rows.npy", rows)
    np.save(tmp_path / "cols.npy", cols)
    np.save(tmp_path / "vals.npy", vals)
    code = (
        "import sys, numpy as np\n"
        "from merge_spmv_tpu_torch.formats import native_io\n"
        "d = sys.argv[1]\n"
        "r, c, v = (np.load(f'{d}/{k}.npy') for k in ('rows','cols','vals'))\n"
        "ro, ci, cv = native_io.coo_to_csr(500, r, c, v)\n"
        "np.save(f'{d}/ro.npy', ro); np.save(f'{d}/ci.npy', ci)\n"
        "np.save(f'{d}/cv.npy', cv)\n")
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = JCsr.from_coo(JCoo(500, 40, rows, cols, vals), use_native=False)
    np.testing.assert_array_equal(np.load(tmp_path / "ro.npy"),
                                  want.row_offsets)
    np.testing.assert_array_equal(np.load(tmp_path / "ci.npy"),
                                  want.col_indices)
    np.testing.assert_array_equal(np.load(tmp_path / "cv.npy"), want.values)


def _special_values(n, seed):
    rs = np.random.RandomState(seed)
    vals = np.concatenate([
        rs.uniform(0.1, 1, n),
        rs.standard_normal(n) * 10.0 ** rs.randint(-30, 30, n),
        rs.randint(-1000, 1000, n).astype(np.float64),
        rs.uniform(-1, 1, n).astype(np.float32).astype(np.float64),
        rs.randint(0, 2**62, n, dtype=np.int64).view(np.float64),
    ])
    vals[:12] = [0.0, -0.0, 1e16, 9999999999999998.0, 1e-5, 0.0001,
                 1.5e300, 5e-324, np.inf, -np.inf, np.nan, 123456789.0]
    return vals


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_writer_bytes_equal_the_jax_writer(dtype, tmp_path, monkeypatch):
    """write_market's native path: the JAX package's Python writer's bytes
    (Python's repr of every value: shortest digits, fixed or scientific
    notation, signed zero, inf, nan); and its Python loop, where the
    library is unavailable, the same."""
    with np.errstate(over="ignore"):   # float32: large values become inf
        vals = _special_values(20_000, 3).astype(dtype)
    n = len(vals)
    rs = np.random.RandomState(4)
    rows = rs.randint(0, 1 << 30, n).astype(np.int32)
    cols = rs.randint(0, 1 << 30, n).astype(np.int32)
    a, b = tmp_path / "jax.mtx", tmp_path / "port.mtx"
    jmarket.write_market(str(a), 1 << 30, 1 << 30, rows, cols, vals,
                         comment="c")
    assert native_io.write_market(
        str(b), f"%%MatrixMarket matrix coordinate real general\n% c\n"
        f"{1 << 30} {1 << 30} {n}\n", rows, cols, vals)
    assert filecmp.cmp(a, b, shallow=False)
    market.write_market(str(b), 1 << 30, 1 << 30, rows, cols, vals,
                        comment="c")
    assert filecmp.cmp(a, b, shallow=False)
    monkeypatch.setattr(native_io, "write_market", lambda *a: False)
    market.write_market(str(b), 1 << 30, 1 << 30, rows, cols, vals,
                        comment="c")
    assert filecmp.cmp(a, b, shallow=False)


def test_written_file_parses_back_bit_equal(tmp_path):
    coo = CooMatrix.random_powerlaw(3000, 2500, 80_000, seed=9)
    path = str(tmp_path / "rt.mtx")
    coo.to_market(path)
    back = CooMatrix.from_market(path)
    want = JCoo.from_market(path, use_native=False)
    for a, b, c in zip((back.rows, back.cols, back.vals),
                       (want.rows, want.cols, want.vals),
                       (coo.rows, coo.cols, coo.vals)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
