"""The port's corpus tools (merge_spmv_tpu_torch/tools/{make_corpus,
make_corpus_stats,eval_corpus,corpus_stats}.py) held against the TPU
package's tools/ scripts, which are loaded by path, unchanged.

Tolerances: file names, generator names and COO arrays exactly equal; the
probes' parses exactly equal; correlations equal to 1e-12 (and the
rounded record keys exactly); the TPU package's CORPUS_STATS.json
reproduced key for key.
"""

import importlib.util
import json
import math
import statistics
from pathlib import Path

import numpy as np
import pytest

from merge_spmv_tpu.formats.coo import CooMatrix as JCoo
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.tools import corpus_stats as CS
from merge_spmv_tpu_torch.tools import eval_corpus as EC
from merge_spmv_tpu_torch.tools import make_corpus as MC
from merge_spmv_tpu_torch.tools import make_corpus_stats as MS

REPO = Path(__file__).resolve().parents[1]
JAX_PREF = ("Merge CsrMV (pallas)", "XLA CsrMV")
MERGE_CPU, LIB_CPU = "Merge CsrMV (plain on CPU)", "torch.sparse CsrMV (CPU)"


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_reference", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The mini corpus written by both packages' make_corpus."""
    root = tmp_path_factory.mktemp("corpus")
    jdir, tdir = root / "jax", root / "port"
    assert _tool("make_corpus").main([str(jdir)]) == 0
    assert MC.main([str(tdir)]) == 0
    return jdir, tdir


def test_mini_corpus_file_names(corpora):
    jdir, tdir = corpora
    names = sorted(p.name for p in tdir.glob("*.mtx"))
    assert names == sorted(p.name for p in jdir.glob("*.mtx"))
    assert len(names) == 25
    assert sum(n.startswith("probe_") for n in names) == 6


def test_mini_corpus_text(corpora):
    """Every file's text is the TPU package's but for the writer's comment
    line ("generated by <package>")."""
    jdir, tdir = corpora
    for p in sorted(tdir.glob("*.mtx")):
        mine = p.read_text().splitlines()
        theirs = (jdir / p.name).read_text().splitlines()
        if p.name.startswith("probe_"):
            assert mine == theirs, p.name
        else:
            assert mine[1] == "% generated by merge_spmv_tpu_torch"
            assert mine[:1] + mine[2:] == theirs[:1] + theirs[2:], p.name


@pytest.mark.parametrize("probe", ["probe_array", "probe_integer",
                                   "probe_pattern", "probe_pattern_sym",
                                   "probe_skew", "probe_symmetric"])
def test_probe_parse_matches_jax(corpora, probe):
    """The port's parse (native) of each banner probe: the JAX package's
    (NumPy) arrays after a (row, col) lexsort, values bit-equal."""
    jdir, tdir = corpora
    t = CooMatrix.from_market(str(tdir / f"{probe}.mtx"))
    j = JCoo.from_market(str(jdir / f"{probe}.mtx"), use_native=False)
    assert (t.num_rows, t.num_cols) == (j.num_rows, j.num_cols)
    to, jo = np.lexsort((t.cols, t.rows)), np.lexsort((j.cols, j.rows))
    np.testing.assert_array_equal(t.rows[to], j.rows[jo])
    np.testing.assert_array_equal(t.cols[to], j.cols[jo])
    np.testing.assert_array_equal(t.vals[to], j.vals[jo])


def test_stats_corpus_names():
    names = sorted(MS.build_gens())
    assert names == sorted(_tool("make_corpus_stats").build_gens())
    assert len(names) == 103


FAMILIES = {
    "banded": (3000, 64, 5, 11),
    "powerlaw_local": (4000, 1.5, 8, 256, 12),
    "uniform_spread": (3000, 6, 100, 13),
    "hub_cols": (5000, 16, 0.6, 8, 14),
    "tridiag": (2048,),
    "empty_heavy": (20000, 900, 4, 15),
    "block_community": (4096, 16, 6, 16),
    "kron_like": (4096, 30000, 17),
    "rect_tall": (5000, 300, 3, 18),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generator_family_bit_equal(family):
    ref = _tool("make_corpus_stats")
    args = FAMILIES[family]
    t, j = getattr(MS, family)(*args), getattr(ref, family)(*args)
    assert isinstance(t, CooMatrix)
    assert (t.num_rows, t.num_cols) == (j.num_rows, j.num_cols)
    for field in ("rows", "cols", "vals"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_stats_corpus_writes_only_the_named(tmp_path):
    assert MS.main([str(tmp_path), "--only", "tridiag_512k"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["tridiag_512k.mtx"]
    coo = CooMatrix.from_market(str(tmp_path / "tridiag_512k.mtx"))
    want = _tool("make_corpus_stats").build_gens()["tridiag_512k"]()
    np.testing.assert_array_equal(coo.rows, want.rows)
    np.testing.assert_array_equal(coo.cols, want.cols)
    np.testing.assert_array_equal(coo.vals, want.vals)
    with pytest.raises(SystemExit):
        MS.main([str(tmp_path), "--only", "no_such_matrix"])


def test_eval_corpus_cpu_rows(corpora, tmp_path):
    """Four files through eval_corpus --cpu: every row parses with the JAX
    package's load_rows given the port's display name, none says ERROR
    or FAIL, and the port's CORPUS_STATS.json holds both groups."""
    _, tdir = corpora
    four = tmp_path / "four"
    four.mkdir()
    for name in ("grid2d_64", "wheel_1k", "powerlaw_rect", "probe_symmetric"):
        (four / f"{name}.mtx").write_bytes((tdir / f"{name}.mtx").read_bytes())
    out = tmp_path / "rows.csv"
    assert EC.main([str(four), "--cpu", "--out", str(out)]) == 0
    text = out.read_text()
    assert text.splitlines()[0] == EC.HEADER
    assert "ERROR" not in text and "FAIL" not in text
    assert "TIMEOUT" not in text
    ref = _tool("corpus_stats")
    for name in (MERGE_CPU, LIB_CPU):
        rows, skipped = ref.load_rows(str(out), backend_pref=(name,))
        assert sorted(r["dataset"] for r in rows) == ["grid2d_64",
                                                      "powerlaw_rect"]
        assert sorted(skipped) == [("probe_symmetric", "trivial"),
                                   ("wheel_1k", "trivial")]
        assert all(r["avg_ms"] > 0 and r["gflops"] > 0 for r in rows)
    stats = json.loads((tmp_path / "CORPUS_STATS.json").read_text())
    rec = stats["rows.csv"]
    assert rec[MERGE_CPU]["rows_used"] == rec[LIB_CPU]["rows_used"] == 2
    assert rec["merge_vs_library"]["rows_both"] == 2
    assert {r["policy"] for r in rec["merge_vs_library"]["worst"]} == {
        "stream"}
    # a resumed run has nothing left to do and keeps every row
    assert EC.main([str(four), "--cpu", "--out", str(out)]) == 0
    assert out.read_text() == text


def test_reproduces_the_tpu_corpus_stats():
    """results_corpus_all.csv with the TPU package's backend preference:
    its CORPUS_STATS.json (a TPU v5e sweep) key for key."""
    csv = REPO / "merge_spmv_tpu" / "bench" / "results_corpus_all.csv"
    want = json.loads((csv.parent / "CORPUS_STATS.json").read_text())
    rec = CS.record(str(csv), JAX_PREF)
    assert rec == want["results_corpus_all.csv"]
    assert rec["rows_used"] == 55 and len(rec["rows_skipped"]) == 8
    assert (rec["corr_gflops_vs_row_cov"], rec["corr_runtime_vs_nnz"],
            rec["corr_log_runtime_vs_log_nnz"]) == (0.014, -0.022, 0.749)


def _synthetic_csv(path, names, seed=0, fail_row=None):
    """Rows in the driver's --quiet layout with one 5-field group per
    name, the probes' trivial sizes and one ERROR / TIMEOUT row."""
    rs = np.random.RandomState(seed)
    lines = [EC.HEADER, "# device: NVIDIA H100 80GB HBM3, 700.00 W"]
    for i in range(40):
        nnz = int(rs.randint(2_000, 5_000_000))
        cov = float(rs.uniform(0, 30))
        row = [f"m{i}", f"m{i}", "1000", "1000", str(nnz), "4.00000",
               "1.00000", f"{cov:.5f}", "0.10000"]
        for k, name in enumerate(names):
            ms = nnz * rs.uniform(1e-8, 4e-8) * (1 + k)
            row += [name, "12.00000", f"{ms:.5f}",
                    f"{2 * nnz / ms / 1e6:.6f}", "100.000"]
        row += ["merge_policy=" + ("l1" if i % 3 else "stream")]
        if i == fail_row:
            row += ["FAIL=merge"]
        lines.append(", ".join(row) + ", ")
    lines += ["m_err, ERROR rc=1", "m_to, TIMEOUT"]
    path.write_text("\n".join(lines) + "\n")


def test_record_equals_jax_main_on_a_synthetic_csv(tmp_path):
    ref = _tool("corpus_stats")
    csv = tmp_path / "synthetic.csv"
    _synthetic_csv(csv, JAX_PREF)
    assert ref.main([str(csv)]) == 0
    want = json.loads((tmp_path / "CORPUS_STATS.json").read_text())
    assert CS.record(str(csv), JAX_PREF) == want["synthetic.csv"]
    # the unrounded correlations too, to 1e-12
    rows, _ = CS.load_rows(str(csv), JAX_PREF)
    jrows, _ = ref.load_rows(str(csv))
    assert [r["dataset"] for r in rows] == [r["dataset"] for r in jrows]
    for xs, ys in ((("row_length_variation",), "gflops"),
                   (("num_nonzeros",), "avg_ms")):
        a = CS.pearson([r[xs[0]] for r in rows], [r[ys] for r in rows])
        b = ref.pearson([r[xs[0]] for r in jrows], [r[ys] for r in jrows])
        assert abs(a - b) <= 1e-12


def test_port_groups_and_speedups(tmp_path):
    """The port's main on its own display names: one JAX record per group
    (the JAX load_rows given that name, to 1e-12), the device line, and
    the harmonic mean of cuSPARSE's avg_ms over merge's."""
    ref = _tool("corpus_stats")
    csv = tmp_path / "port.csv"
    names = ("Merge CsrMV (CUDA)", "cuSPARSE CsrMV")
    _synthetic_csv(csv, names, seed=3, fail_row=5)
    assert CS.main([str(csv)]) == 0
    out = json.loads((tmp_path / "CORPUS_STATS.json").read_text())["port.csv"]
    assert out["device"] == ["NVIDIA H100 80GB HBM3, 700.00 W"]
    for name in names:
        jrows, _ = ref.load_rows(str(csv), backend_pref=(name,))
        jrows = [r for r in jrows if r["dataset"] != "m5"]   # FAIL row
        rec = out[name]
        assert rec["rows_used"] == len(jrows)
        # the FAIL row is skipped by name; the ERROR and TIMEOUT rows hold
        # fewer than 9 fields and are passed over, as the JAX reader does
        assert "m5" in rec["rows_skipped"]
        assert not {"m_err", "m_to"} & set(rec["rows_skipped"])
        r = ref.pearson([r["row_length_variation"] for r in jrows],
                        [r["gflops"] for r in jrows])
        assert rec["corr_gflops_vs_row_cov"] == round(r, 3)
        r = ref.pearson([r["num_nonzeros"] for r in jrows],
                        [r["avg_ms"] for r in jrows])
        assert rec["corr_runtime_vs_nnz"] == round(r, 3)
    m, _ = ref.load_rows(str(csv), backend_pref=(names[0],))
    c, _ = ref.load_rows(str(csv), backend_pref=(names[1],))
    c = {r["dataset"]: r["avg_ms"] for r in c}
    ratios = {r["dataset"]: c[r["dataset"]] / r["avg_ms"] for r in m
              if r["dataset"] != "m5"}
    s = out["merge_vs_library"]
    assert s["rows_both"] == len(ratios)
    assert abs(s["hmean_speedup"]
               - statistics.harmonic_mean(list(ratios.values()))) <= 1e-12
    big = [ratios[r["dataset"]] for r in m
           if r["dataset"] in ratios and r["num_nonzeros"] > 300_000]
    assert s["rows_above_300k_nnz"] == len(big)
    assert abs(s["hmean_speedup_above_300k_nnz"]
               - statistics.harmonic_mean(big)) <= 1e-12
    assert abs(s["median_speedup"]
               - statistics.median(ratios.values())) <= 1e-12
    for pol in ("l1", "stream"):
        xs = [ratios[r["dataset"]] for r in m if r["dataset"] in ratios
              and ("l1" if int(r["dataset"][1:]) % 3 else "stream") == pol]
        got = s["by_policy"][pol]
        assert got["rows"] == len(xs)
        assert abs(got["hmean_speedup"]
                   - statistics.harmonic_mean(xs)) <= 1e-12
    worst = sorted(ratios.values())[:10]
    assert [w["speedup"] for w in s["worst"]] == worst
    assert all(w["policy"] in ("l1", "stream") for w in s["worst"])
    assert not any(math.isnan(w["speedup"]) for w in s["worst"])
