"""The port's benchmark tools (merge_spmv_tpu_torch/tools/bench_{baseline_
configs,spmm,skew}.py) and their generators (bench/matrices.py) held
against the TPU package's tools.

* tools/bench_baseline_configs.py is loaded by path, unchanged: its
  ``banded``, ``powerlaw_web`` and ``rmat`` give the port's arrays bit for
  bit at every argument set its ``main()`` uses (:293, :312, :319,
  :359-360, :393, :405), at small n, and the port tool's matrices are
  those arrays' CSR.
* tools/bench_skew.py draws its matrices inline, so a copy of it runs
  under ``tmp_path/tools/`` at n = 2^12 (its record lands in
  ``tmp_path``, never in the repository), with the JAX package's
  ``build_operator`` wrapped to save each matrix it is given: the port's
  ``skew_trio`` is those matrices bit for bit, and the port tool's
  ``row_cov`` and ``nnz`` are the copy's record's.
* Each tool's CPU run (the kernels' plain versions) at a small size:
  every entry verified against gold, and every key of the TPU record at
  the repository's root present (BASELINE_CONFIGS.json, BENCH_SPMM.json,
  SKEW.json), with the JAX tool's meaning where the value is not a time.

Tolerances: arrays and counts exactly equal; ``row_cov`` to 1e-12
relative (the same float64 formula over the same row lengths).
"""

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from merge_spmv_tpu_torch.bench import matrices as BM
from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.tools import bench_baseline_configs as BC
from merge_spmv_tpu_torch.tools import bench_skew as SK
from merge_spmv_tpu_torch.tools import bench_spmm as SP

REPO = Path(__file__).resolve().parents[1]
SCALE = 3e-4          # the tests' --scale of the five configs
SKEW_N = 1 << 12


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JB = _jax_tool("bench_baseline_configs")


def _equal(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


# main()'s generator calls, n and nnz cut to about 1/1000
GEN_ARGS = {
    "cant_f64": ("banded", (62, 64, 400.0, 11, np.float64)),            # :293
    "webbase_1M": ("powerlaw_web", (1000, 3105, 0.85, 16384, 12,
                                    np.float32)),                       # :312
    "wb_edu": ("powerlaw_web", (9845, 57156, 0.95, 32768, 13,
                                np.float32)),                           # :319
    "cant_f32": ("banded", (62, 64, 400.0, 11, np.float32)),            # :359
    "pdb1HYS": ("banded", (36, 119, 300.0, 14, np.float32)),            # :360
    "cage15": ("banded", (5154, 19, 10000.0, 15, np.float64)),          # :393
    "kron": ("rmat", (11, 182082, 16, np.float64)),                     # :405
}


@pytest.mark.parametrize("case", sorted(GEN_ARGS))
def test_generators_bit_equal_to_jax(case):
    fn, args = GEN_ARGS[case]
    want = getattr(JB, fn)(*args)
    got = getattr(BM, fn)(*args)
    for w, g in zip(want, got):
        assert _equal(g, w)


# the port tool's builders at SCALE, against the JAX tool's build() of its
# generators at the same scaled arguments
BUILDERS = {
    "cant": (lambda: BC.cant_csr(np.float64, SCALE),
             lambda: JB.banded(BC._sized(62451, SCALE), 64, 400.0, 11,
                               np.float64)),
    "pdb1HYS": (lambda: BC.pdb1hys_csr(SCALE),
                lambda: JB.banded(BC._sized(36417, SCALE), 119, 300.0, 14,
                                  np.float32)),
    "webbase_1M": (lambda: BC.webbase_1m_csr(SCALE),
                   lambda: JB.powerlaw_web(BC._sized(1_000_005, SCALE),
                                           BC._sized(3_105_536, SCALE),
                                           0.85, 16384, 12, np.float32)),
    "wb_edu": (lambda: BC.wb_edu_csr(SCALE),
               lambda: JB.powerlaw_web(BC._sized(9_845_725, SCALE),
                                       BC._sized(57_156_537, SCALE), 0.95,
                                       32768, 13, np.float32)),
    "cage15": (lambda: BC.cage15_csr(SCALE),
               lambda: JB.banded(BC._sized(5_154_859, SCALE), 19, 10000.0,
                                 15, np.float64)),
    "kron": (lambda: BC.kron_csr(SCALE),
             lambda: JB.rmat(21 + round(math.log2(SCALE)),
                             BC._sized(182_082_942, SCALE), 16,
                             np.float64)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_config_matrix_is_jax_build(name):
    """rows = the largest index drawn + 1, duplicates kept, dtype (the
    JAX tool's build(), :285-288)."""
    port, jax_gen = BUILDERS[name]
    got = port()
    r, c, v = jax_gen()
    n = int(max(r.max(), c.max())) + 1
    want = CsrMatrix.from_coo(CooMatrix(n, n, r, c, v), use_native=False)
    assert got.num_rows == got.num_cols == n
    assert got.num_nonzeros == r.size
    for k in ("row_offsets", "col_indices", "values"):
        assert _equal(getattr(got, k), getattr(want, k).astype(
            getattr(got, k).dtype))
    assert got.values.dtype == v.dtype


def test_kron_levels_at_full_scale():
    """At scale 1 the kron stand-in is rmat(21, 182,082,942): 2^21 rows
    at most, the TPU record's nnz."""
    assert 21 + min(0, round(math.log2(1.0))) == 21
    assert BC._sized(182_082_942, 1.0) == 182_082_942
    assert BC._sized(62451, 1.0) * 64 == 3_996_864      # cant's nnz
    assert BC._sized(5_154_859, 1.0) * 19 == 97_942_321  # cage15's nnz


# ---------------------------------------------------------------- skew

_CAPTURE = '''
import runpy, sys
import numpy as np
import merge_spmv_tpu.ops.operator as O

real = O.build_operator
seen = []


def capture(csr, *a, **k):
    np.savez(f"m{len(seen)}.npz", row_offsets=csr.row_offsets,
             col_indices=csr.col_indices, values=csr.values)
    seen.append(csr.num_nonzeros)
    return real(csr, *a, **k)


O.build_operator = capture
sys.argv = ["tools/bench_skew.py", sys.argv[1]]
try:
    runpy.run_path("tools/bench_skew.py", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
'''


@pytest.fixture(scope="module")
def jax_skew(tmp_path_factory):
    """The JAX tool's copy run at SKEW_N: its three matrices and its
    record, all under a temporary directory."""
    root = tmp_path_factory.mktemp("jax_skew")
    (root / "tools").mkdir()
    shutil.copy(REPO / "tools" / "bench_skew.py", root / "tools")
    shutil.copy(REPO / "bench.py", root)
    (root / "capture.py").write_text(_CAPTURE)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "capture.py", str(SKEW_N)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    mats = [np.load(root / f"m{i}.npz") for i in range(3)]
    record = json.loads((root / "SKEW.json").read_text())
    return mats, record


def test_skew_trio_bit_equal_to_jax(jax_skew):
    mats, _ = jax_skew
    got = list(BM.skew_trio(SKEW_N, 8))
    assert [label for label, _ in got] == ["uniform", "powerlaw", "wheel"]
    for (_, csr), want in zip(got, mats):
        for k in ("row_offsets", "col_indices", "values"):
            assert _equal(getattr(csr, k), want[k])


@pytest.fixture(scope="module")
def port_skew():
    return SK.run(SKEW_N, 8, "cpu")


@pytest.mark.parametrize("label", ["uniform", "powerlaw", "wheel"])
def test_skew_cpu_run_matches_jax_record(port_skew, jax_skew, label):
    _, record = jax_skew
    got, want = port_skew[label], record[label]
    assert set(want) <= set(got)
    assert got["verified"] is True
    assert got["nnz"] == want["nnz"]
    assert got["row_cov"] == pytest.approx(want["row_cov"], rel=1e-12,
                                           abs=5e-4)
    assert got["avg_ms"] > 0 and "cusparse_ms" not in got


def test_skew_record_keys(port_skew):
    with open(REPO / "SKEW.json") as f:
        tpu = json.load(f)
    assert set(tpu) <= set(port_skew)
    assert port_skew["rows"] == SKEW_N
    assert port_skew["device"] == "cpu" and port_skew["nvidia_smi"] is None
    u, p = port_skew["uniform"], port_skew["powerlaw"]
    assert port_skew["powerlaw_over_uniform_per_nnz"] == pytest.approx(
        (p["gflops"] / u["gflops"]) * u["nnz"] / p["nnz"])
    # the JAX formula is the time ratio; the added key is per nonzero
    assert port_skew["powerlaw_over_uniform_per_nnz"] == pytest.approx(
        u["avg_ms"] / p["avg_ms"])
    assert port_skew["powerlaw_over_uniform_gflops"] == pytest.approx(
        (u["avg_ms"] / u["nnz"]) / (p["avg_ms"] / p["nnz"]))


# ---------------------------------------------------------------- spmm

def test_spmm_cpu_run_verified_with_jax_keys(tmp_path):
    out = tmp_path / "spmm.json"
    assert SP.main(["6", "4", "--cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    with open(REPO / "BENCH_SPMM.json") as f:
        tpu = json.load(f)
    assert set(tpu) <= set(rec)
    for part in ("column_loop", "k1m", "dia", "dia_column"):
        assert set(tpu.get(part, {})) <= set(rec[part])
        assert rec[part]["verified"] is True
        # the plain versions on the CPU: no kernel launched
        assert rec[part]["launches"] == {"merge_tile_fused": 0,
                                         "merge_tile_mm": 0,
                                         "dia_matvec": 0, "dia_matmat": 0}
    assert rec["column_loop"]["method"] == rec["dia_column"]["method"] \
        == "column"
    assert (rec["rows"], rec["nnz"], rec["k"]) == (216, 1080, 4)
    assert rec["dia"]["diagonals"] == 6 and rec["dia"]["rest_nnz"] == 0
    assert rec["device"] == "cpu"


# ---------------------------------------------------------------- configs

@pytest.fixture(scope="module")
def configs_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("configs") / "rec.json"
    return out, BC.run(BC.CONFIGS, out=out, device="cpu", scale=SCALE)


TPU_CONFIGS = json.loads((REPO / "BASELINE_CONFIGS.json").read_text())


@pytest.mark.parametrize("key", sorted(TPU_CONFIGS))
def test_config_entry_has_jax_keys_and_is_verified(configs_run, key):
    _, rec = configs_run
    want = TPU_CONFIGS[key]
    got = rec[key]
    if not isinstance(want, dict):
        assert isinstance(got, float) and got > 0
        return
    if "declined" in got or "declined" in want:
        # whether the split finds hot windows depends on the size
        assert got.get("verified", True) is True
        return
    assert set(want) <= set(got)
    assert got["verified"] is True
    for k in ("dtype", "k", "method", "gen"):
        if k in want and not (k == "method" and key.startswith("spmm")):
            assert got[k] == want[k]
    if key.startswith("spmm"):
        # op.mm is one K1m launch here; the TPU's method, the column
        # loop, is timed and verified beside it
        assert (got["method"], want["method"]) == ("k1m", "column_loop")
        assert got["column_loop_verified"] is True
        assert got["column_loop_ms"] > 0
    assert got["timing"] == "host" and got["device"] == "cpu"
    assert got.get("pct_peak") is None
    if got.get("dtype") == "float64":
        assert 0 <= got["gold_err_over_fp64_bound"] <= 1


@pytest.mark.parametrize("summed_in", ["float64", "float32"])
def test_fp64_check_holds_float64_sums_only(summed_in):
    """The float64 configs' gate (bench/measure.py::fp64_check): a float64
    sum in another order is within 2 gamma_n |A| |x| of gold; the same
    product summed in float32 passes compare_results' float32 limits but
    not that bound."""
    from merge_spmv_tpu_torch.utils.compare import compare_results
    csr = BC.cant_csr(np.float64, SCALE)
    x = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols)
    gold = csr.spmv_gold(x)
    rows = csr.row_ids()
    if summed_in == "float64":
        # each row's products summed last to first
        prods = (csr.values * x[csr.col_indices])[::-1]
        y = np.bincount(rows[::-1], weights=prods, minlength=csr.num_rows)
    else:
        y = csr.astype(np.float32).spmv_gold(
            x.astype(np.float32)).astype(np.float64)
    bound = csr.spmv_abs_bound(x, segmented_block=0)
    assert compare_results(y, gold, verbose=False, abs_bound=bound) is None
    ok, worst = M.fp64_check(y, gold, np.diff(csr.row_offsets), bound)
    assert ok is (summed_in == "float64")
    assert (worst <= 1) is ok


def test_config_record_on_disk_is_the_run(configs_run):
    out, rec = configs_run
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))


def test_config_record_resumes_and_force_drops_only_named(configs_run,
                                                          tmp_path):
    out, rec = configs_run
    path = tmp_path / "rec.json"
    marked = json.loads(out.read_text())
    for k in marked:
        if isinstance(marked[k], dict):
            marked[k]["marker"] = True
    M.save_record(path, marked)
    again = BC.run(BC.CONFIGS, out=path, device="cpu", scale=SCALE)
    assert again == marked                           # nothing re-measured
    forced = BC.run(("cant",), out=path, device="cpu", scale=SCALE,
                    force=True)
    assert "marker" not in forced["cant_class"]
    assert forced["cant_class"]["verified"] is True
    for k in marked:
        if not k.startswith("cant_class"):
            assert forced[k] == marked[k]


def test_stale_webbase_generator_is_dropped(configs_run, tmp_path):
    out, rec = configs_run
    stale = json.loads(out.read_text())
    stale["wb_edu_class"]["gen"] = BC.WB_GEN - 1
    path = tmp_path / "stale.json"
    M.save_record(path, stale)
    got = BC.run(("cant",), out=path, device="cpu", scale=SCALE)
    assert "wb_edu_class" not in got and "webbase_1M_class" in got


def test_tools_never_write_the_tpu_records():
    import torch
    for name in ("BASELINE_CONFIGS", "BENCH_SPMM", "SKEW", "WEAKSCALING",
                 "BENCH_LARGE", "SPLIT_COMPACT", "BENCH_HOTCOLD"):
        for dev in ("cpu", "cuda"):
            p = M.record_path(name, torch.device(dev))
            assert p.parent == REPO / "merge_spmv_tpu_torch" / "bench"
            assert p.name != f"{name}.json"


def test_unknown_config_is_refused():
    with pytest.raises(SystemExit):
        BC.main(["cant", "nlpkkt240", "--cpu"])
