"""The port's circuit- and kron-class benchmark tools
(merge_spmv_tpu_torch/tools/{bench_large,bench_hotcold,
split_compact_bench}.py) held against the TPU package's tools.

* tools/bench_large.py is loaded by path, unchanged: its
  ``make_circuit_like`` gives bench/matrices.py's arrays bit for bit at
  about 20K rows, and the port tools' matrices (``circuit_csr``, which
  builds the circuit class and its quarter, and the kron class of
  tools/bench_hotcold.py:52-56) are the JAX tools' CSR arrays.
* Each tool's CPU run (the kernels' plain versions) at a small size:
  every entry verified against gold, no key of the root's TPU records
  (BENCH_LARGE.json, SPLIT_COMPACT.json, read only) missing, nor of the
  hot/cold record that tools/bench_hotcold.py:69-114 writes; ``split`` the
  fastest verified entry of ``split_sweep``; the speed-ups by the JAX
  formulas.
* The tools' operators on the small matrices (quantile B = 8, geometric
  (8, 32) and compact splits, hot/cold, the device-built split) against
  the JAX operators with the same arguments and one explicit
  ``tile_items``: both within compare_results(..., abs_bound=
  spmv_abs_bound) of gold and of each other.

Tolerances: arrays exactly equal; the speed-ups to 1e-12 relative (the
same two floats divided).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
import merge_spmv_tpu.ops.split as J
from merge_spmv_tpu_torch.bench import matrices as BM
from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.ops import split as S
from merge_spmv_tpu_torch.tools import bench_hotcold as BH
from merge_spmv_tpu_torch.tools import bench_large as BL
from merge_spmv_tpu_torch.tools import split_compact_bench as SC
from merge_spmv_tpu_torch.utils.compare import compare_results

REPO = Path(__file__).resolve().parents[1]
# the small sizes of the CPU runs
CIRCUIT = (20_000, 200_000)
KRON = (12, 200_000)
SWEEP = (8, 16, 32)
COMPACT_BANDS = (16, 32)      # the root SPLIT_COMPACT.json's
TILE = 2048                   # one tile size for both packages


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JL = _jax_tool("bench_large")
JB = _jax_tool("bench_baseline_configs")


def _root(name):
    with open(REPO / name) as f:
        return json.load(f)


def _paths(rec, prefix=""):
    """Every key of a record as a dotted path, into nested entries."""
    out = set()
    for k, v in rec.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _paths(v, f"{prefix}{k}.")
    return out


def _jax_csr(rows, cols, vals, n=None):
    n = n or int(max(rows.max(), cols.max())) + 1
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(n, n, rows, cols, vals)
                                   ).astype(np.float32)


def _same_arrays(port, jax_csr):
    assert (port.num_rows, port.num_cols) == (jax_csr.num_rows,
                                              jax_csr.num_cols)
    for name in ("row_offsets", "col_indices", "values"):
        a, b = getattr(port, name), getattr(jax_csr, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


# ------------------------------------------------------------- generators

@pytest.mark.parametrize("n,nnz,seed", [
    (20_000, 200_000, 0), (19_999, 150_001, 1), (21_000, 400_000, 7),
    (18_000, 18_000, 3)])
def test_make_circuit_like_bit_equal_to_jax(n, nnz, seed):
    want = JL.make_circuit_like(n, nnz, seed=seed)
    got = BM.make_circuit_like(n, nnz, seed=seed)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.fixture(scope="module")
def circuit():
    return BL.circuit_csr(*CIRCUIT)


@pytest.fixture(scope="module")
def kron():
    return BH.kron_csr(*KRON)


def test_circuit_matrix_is_the_jax_tools(circuit):
    """tools/bench_large.py:94-96's CSR, n the rows asked for."""
    n = CIRCUIT[0]
    _same_arrays(circuit, _jax_csr(*JL.make_circuit_like(*CIRCUIT), n=n))


def test_kron_matrix_is_the_jax_tools(kron):
    """tools/bench_hotcold.py:52-56's CSR: square at the largest index
    drawn + 1."""
    _same_arrays(kron, _jax_csr(*JB.rmat(*KRON, 16, np.float32)))


# ------------------------------------------------------------- CPU runs

@pytest.fixture(scope="module")
def large(circuit):
    return BL.run(sweep=SWEEP, device="cpu", csr=circuit)


@pytest.fixture(scope="module")
def hotcold(kron):
    return BH.run(device="cpu", csr=kron)


@pytest.fixture(scope="module")
def compact(circuit):
    return SC.run(bands=COMPACT_BANDS, device="cpu", csr=circuit)


# the hot/cold record's keys, as tools/bench_hotcold.py writes them:
# :69-70 the matrix, :85-86 merge, :107-113 hotcold, :114 the speed-up
HOTCOLD_JAX_KEYS = {
    "metric": (), "rows": (), "nnz": (),
    "merge": ("avg_ms", "effective_gbps", "verified"),
    "hotcold": ("avg_ms", "effective_gbps", "verified", "hot_windows",
                "hot_nnz", "cold_nnz", "split_setup_ms"),
    "hotcold_speedup": (),
}


@pytest.mark.parametrize("tool", ["bench_large", "bench_hotcold",
                                  "split_compact_bench"])
def test_every_entry_verified_and_every_key_present(tool, request):
    rec, keys = {
        "bench_large": lambda: (request.getfixturevalue("large"),
                                BL.record_keys(SWEEP)),
        "bench_hotcold": lambda: (request.getfixturevalue("hotcold"),
                                  BH.RECORD_KEYS),
        "split_compact_bench": lambda: (request.getfixturevalue("compact"),
                                        SC.record_keys(COMPACT_BANDS)),
    }[tool]()
    assert M.record_faults(rec, keys) == []
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None
    assert rec["timing"] == "host"


def test_bench_large_has_the_root_records_keys(large):
    want = _paths(_root("BENCH_LARGE.json"))
    assert want <= _paths(large)
    # the smoke run's check is at least the root record's
    keys = BL.record_keys(SWEEP)
    assert want <= set(keys) | {f"{p}.{k}" for p, ks in keys.items()
                                for k in ks}


def test_split_compact_has_the_root_records_keys(compact):
    want = _paths(_root("SPLIT_COMPACT.json")) - {"attribution.reading"}
    assert want <= _paths(compact)
    keys = SC.record_keys(COMPACT_BANDS)
    assert want <= set(keys) | {f"{p}.{k}" for p, ks in keys.items()
                                for k in ks}


def test_hotcold_has_the_jax_tools_keys(hotcold):
    text = "\n".join((REPO / "tools" / "bench_hotcold.py"
                      ).read_text().splitlines()[68:114])
    for path, ks in HOTCOLD_JAX_KEYS.items():
        for k in (path, *ks):
            assert f'"{k}"' in text, k
    assert BH.RECORD_KEYS == HOTCOLD_JAX_KEYS
    assert not hotcold["hotcold"].get("declined")
    assert M.record_faults(hotcold, HOTCOLD_JAX_KEYS) == []


def test_split_is_the_fastest_verified_sweep_entry(large):
    sweep = large["split_sweep"]
    assert set(sweep) == {str(b) for b in SWEEP}
    best = min((e for e in sweep.values() if e["verified"]),
               key=lambda e: e["avg_ms"])
    assert large["split"] == best
    assert all(e["edges"] == "quantile" for e in sweep.values())
    assert large["split_geometric"]["edges"] == "(8, 32)"


def test_speedups_are_the_jax_formulas(large, hotcold):
    # tools/bench_large.py:193 and band_sweep.py:145: xla ms / merge ms
    xla = large["xla"]["avg_ms"]
    assert large["merge_vs_xla_speedup"] == pytest.approx(
        xla / large["merge"]["avg_ms"], rel=1e-12)
    assert large["split_vs_xla_speedup"] == pytest.approx(
        xla / large["split"]["avg_ms"], rel=1e-12)
    assert large["xla"]["reused_prior_measurement"] is False
    # tools/bench_hotcold.py:114: merge ms / hot/cold ms
    assert hotcold["hotcold_speedup"] == pytest.approx(
        hotcold["merge"]["avg_ms"] / hotcold["hotcold"]["avg_ms"],
        rel=1e-12)
    lib = hotcold["cusparse"]["avg_ms"]
    assert hotcold["merge_vs_cusparse_speedup"] == pytest.approx(
        lib / hotcold["merge"]["avg_ms"], rel=1e-12)


def test_rates_are_the_jax_byte_model(large):
    """tools/bench_large.py:106, 123-124: nnz * 12 + rows * 8 bytes and
    2 nnz flops per op(x); no peak on the CPU."""
    total = large["nnz"] * 12 + large["rows"] * 8
    assert large["total_bytes"] == total
    m = large["merge"]
    assert m["effective_gbps"] == pytest.approx(total / m["avg_ms"] / 1e6,
                                                rel=1e-12)
    assert m["gflops"] == pytest.approx(
        2 * large["nnz"] / m["avg_ms"] / 1e6, rel=1e-12)
    assert m["pct_peak"] is None and m["x_win"] is None
    assert m["backend"] == "torch" and large["bytes_bound_ms"] is None


def test_split_device_entry(large):
    """tools/split_device_bench.py:89-96: the second build's setup, the
    first less the second as ``stage_compile_s``."""
    d = large["split_device"]
    assert d["edges"] == "quantile(device)" and d["timing"] == "host"
    assert d["stage_compile_s"] == pytest.approx(
        (d["first_setup_ms"] - d["split_setup_ms"]) / 1e3, rel=1e-12)
    assert set(d["stage_ms"]) == {"upload", "edges", "order", "stack",
                                  "plan_prepare"}
    assert d["convert_ms"] == pytest.approx(d["split_setup_ms"]
                                            - d["upload_ms"])


def test_reference_times_are_the_papers():
    text = (REPO / "BASELINE.md").read_text()
    assert "6.92 ms" in text and "12.64 ms" in text
    assert BL.REFERENCE == {"reference_k40_merge_ms": 6.92,
                            "reference_cpu_merge_ms": 12.64}
    root = _root("BENCH_LARGE.json")
    assert all(root[k] == v for k, v in BL.REFERENCE.items())


def test_compact_attribution(compact, circuit):
    """tools/split_compact_bench.py:45's matrix string; the compact stack
    has fewer rows than the plain one over the same bands."""
    att = compact["attribution"]
    for b in COMPACT_BANDS:
        c = compact["configs"][f"B{b}_compact"]
        assert c["stacked_rows"] < att[f"plain_B{b}_stacked_rows"]
        assert att[f"B{b}_kernel_only_ms"] > 0
        assert att[f"B{b}_epilogue_only_ms"] > 0
    assert compact["matrix"] == (f"circuit_like n={circuit.num_rows} "
                                 f"nnz={circuit.num_nonzeros}")


@pytest.mark.parametrize("tool,argv,name,keys", [
    ("bench_large", ["5000", "40000", "--no-sweep", "--no-device"],
     "BENCH_LARGE", BL.record_keys((), False)),
    ("bench_large", ["5000", "40000", "--sweep=8", "--bands=4",
                     "--no-device"],
     "BENCH_LARGE", BL.record_keys((8,), False)),
    ("bench_hotcold", ["10", "40000"], "BENCH_HOTCOLD", BH.RECORD_KEYS),
    ("split_compact_bench", ["5000", "40000", "8"], "SPLIT_COMPACT",
     SC.record_keys((8,))),
])
def test_main_writes_the_record(tool, argv, name, keys, tmp_path):
    mod = {"bench_large": BL, "bench_hotcold": BH,
           "split_compact_bench": SC}[tool]
    out = tmp_path / f"{name}_cpu.json"
    assert mod.main([*argv, "--cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert M.record_faults(rec, keys) == []
    if "--bands=4" in argv:
        assert rec["split_geometric"]["edges"] == "quantile"
        assert set(rec["split_sweep"]) == {"8"}


def test_tools_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for run in (BL.run, BH.run, SC.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(device=None, csr=BL.circuit_csr(100, 500))


# ------------------------------------------------------------- operators

@pytest.fixture(scope="module")
def pair(circuit):
    """(port CSR, JAX CSR, x): the circuit matrix of the CPU runs, x as
    tools/bench_large.py:100 draws it."""
    j = _jax_csr(*JL.make_circuit_like(*CIRCUIT), n=CIRCUIT[0])
    x = np.random.RandomState(1).uniform(0.1, 1.0, CIRCUIT[0]
                                         ).astype(np.float32)
    return circuit, j, x


def _check(got, jax_out, csr, x):
    got = got.numpy()
    bound = csr.spmv_abs_bound(x)
    assert compare_results(got, csr.spmv_gold(x), abs_bound=bound) is None
    assert compare_results(got, np.asarray(jax_out), abs_bound=bound) is None


@pytest.mark.parametrize("kw", [
    {"edges_chunks": "quantile", "num_bands": 8},
    {"edges_chunks": (8, 32), "num_bands": 5},
    {"edges_chunks": "quantile", "num_bands": 16, "compact_rows": True},
], ids=["quantile8", "geometric", "compact16"])
def test_split_operators_match_jax(kw, pair):
    csr, j, x = pair
    op = S.build_split_operator(csr, tile_items=TILE, device="cpu", **kw)
    jop = J.build_split_operator(j, tile_items=TILE, **kw)
    assert op.num_bands == jop.num_bands and op.band_nnz == jop.band_nnz
    assert op.plan.num_rows == jop.op.plan.num_rows
    _check(op(torch.from_numpy(x)), jop(jnp.asarray(x), interpret=True),
           csr, x)


def test_device_split_matches_jax(pair):
    csr, j, _ = pair
    x = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols
                                         ).astype(np.float32)
    op = S.build_split_operator_device(csr, num_bands=16, tile_items=TILE,
                                       device="cpu")
    jop = J.build_split_operator_device(j, num_bands=16, tile_items=TILE)
    assert op.num_bands == jop.num_bands and op.band_nnz == jop.band_nnz
    _check(op(torch.from_numpy(x)), jop(jnp.asarray(x)), csr, x)


@pytest.mark.parametrize("cls", ["circuit", "kron"])
def test_hotcold_operator_matches_jax(cls, pair, kron):
    if cls == "circuit":
        csr, j, x = pair
    else:
        csr, j = kron, _jax_csr(*JB.rmat(*KRON, 16, np.float32))
        x = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols
                                             ).astype(np.float32)
    op = S.build_hotcold_operator(csr, tile_items=TILE, device="cpu")
    jop = J.build_hotcold_operator(j, tile_items=TILE)
    assert (op.num_hot_windows, op.hot_nnz, op.cold_nnz) == (
        jop.num_hot_windows, jop.hot_nnz, jop.cold_nnz)
    assert op.num_hot_windows > 0
    _check(op(torch.from_numpy(x)), jop(jnp.asarray(x), interpret=True),
           csr, x)
