"""Consistency statistics over a corpus sweep CSV — the paper's acceptance
criteria (SC'16 Fig. 9 and Fig. 10) computed from tools/eval_corpus.py
output; the port's counterpart of the TPU package's tools/corpus_stats.py.

The reference's corpus-scale evidence (SURVEY.md section 6, paper Fig. 9):

  * GFLOP/s vs row-length CoV — skew invariance.  Closer to 0 is better:
    GPU merge -0.01, CPU merge -0.07 (vs cuSPARSE -0.24, MKL -0.16).
  * runtime vs nnz — bandwidth-bound linearity.  Closer to 1 is better:
    CPU merge 0.97, GPU merge 0.87 (vs cuSPARSE 0.30).

and Fig. 10: the harmonic mean over the corpus of merge's speed-up against
cuSPARSE CsrMV, 0.84x overall and 1.13x above 300K nonzeros on the K40.

Usage:
    python -m merge_spmv_tpu_torch.tools.corpus_stats [csv ...]

For each CSV, the TPU package's record (``rows_used``, ``rows_skipped``,
the three correlations, ``reference``; the same keys and meaning) for
every backend group the CSV holds, under its display name, and beside
them ``merge_vs_library``: per-row ratios of the library's ``avg_ms`` to
merge's over the rows both timed, their harmonic mean (overall, above
300K nonzeros and per merge gather policy), median and extremes, and the
rows where merge loses most.
Writes CORPUS_STATS.json next to the CSV when given exactly one input.
Rows with missing timings (TIMEOUT / ERROR / below_resolution) or a failed
verification are reported but excluded, as the reference sweep excludes
trivial datasets (eval_csrmv.sh / cpu_spmv.cpp:556-560).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys

__all__ = ["MIN_NNZ", "REFERENCE", "pearson", "load_rows", "groups",
           "record", "speedups", "main"]

MIN_NNZ = 10_000
"""Rows below this are format/parser probes, not perf rows: a matrix
with a few dozen nonzeros times at the per-launch floor regardless of
nnz, so including it in the runtime-vs-nnz Pearson only measures the
floor.  The reference sweep likewise excludes trivial datasets
(cpu_spmv.cpp:556-560)."""

# the port's display names (bench/driver.py::_display_name): on the card,
# then on the CPU (the kernels' plain versions)
MERGE_NAMES = ("Merge CsrMV (CUDA)", "Merge CsrMV (plain on CPU)")
LIBRARY_NAMES = ("cuSPARSE CsrMV", "torch.sparse CsrMV (CPU)")

REFERENCE = {"gpu_merge_skew": -0.01, "cpu_merge_skew": -0.07,
             "cusparse_skew": -0.24,
             "cpu_merge_linearity": 0.97,
             "gpu_merge_linearity": 0.87,
             "cusparse_linearity": 0.30}
# paper Fig. 10: GPU merge CsrMV over cuSPARSE CsrMV, harmonic means
SPEEDUP_REFERENCE = {"gpu_merge_vs_cusparse_hmean": 0.84,
                     "gpu_merge_vs_cusparse_hmean_above_300k_nnz": 1.13}
LARGE_NNZ = 300_000
WORST = 10


def pearson(xs, ys):
    n = len(xs)
    if n < 3:
        return None
    mx = sum(xs) / n
    my = sum(ys) / n
    sxy = sum((a - mx) * (b - my) for a, b in zip(xs, ys))
    sxx = sum((a - mx) ** 2 for a in xs)
    syy = sum((b - my) ** 2 for b in ys)
    if sxx <= 0 or syy <= 0:
        return None
    return sxy / math.sqrt(sxx * syy)


def _fields(line):
    return [p.strip() for p in line.strip().split(",")]


def _groups_of(parts):
    """{display name: (setup_ms, avg_ms, gflops, GB/s)} of a row's
    5-field backend groups after its 9 leading fields."""
    groups = {}
    i = 9
    while i + 4 < len(parts):
        try:
            groups[parts[i]] = tuple(float(p) for p in parts[i + 1:i + 5])
        except ValueError:
            pass
        i += 5
    return groups


def load_rows(path, backend_pref=MERGE_NAMES):
    """Parse eval_corpus rows: 9 leading fields (name, label, rows, cols,
    nnz, mean, std, cov, skewness) then repeating 5-field backend groups
    (display_name, setup_ms, avg_ms, gflops, effective_GBs), then the
    driver's trailing fields (``merge_policy=``, ``k1_launches=``,
    ``FAIL=``).  Takes the
    first group of ``backend_pref`` the row holds.  Sub-MIN_NNZ probes
    are skipped (reason 'trivial'), rows that failed verification too."""
    rows = []
    skipped = []
    with open(path) as f:
        for line in f:
            parts = _fields(line)
            if len(parts) < 9 or not parts[0] or parts[0] == "dataset" \
                    or parts[0].startswith("#"):
                continue
            name = parts[0]
            if any(tok in line for tok in ("TIMEOUT", "ERROR",
                                           "below_resolution")):
                skipped.append((name, "no timing"))
                continue
            if "FAIL" in line:
                skipped.append((name, "verification FAIL"))
                continue
            try:
                nnz = float(parts[4])
                cov = float(parts[7])
            except ValueError:
                skipped.append((name, "bad stats"))
                continue
            if nnz < MIN_NNZ:
                skipped.append((name, "trivial"))
                continue
            groups = _groups_of(parts)
            grp = next((groups[b] for b in backend_pref if b in groups),
                       None)
            if grp is None:
                skipped.append((name, "no backend group"))
                continue
            tail = dict(p.split("=", 1) for p in parts[9:] if "=" in p)
            rows.append({"dataset": name, "num_nonzeros": nnz,
                         "row_length_variation": cov,
                         "avg_ms": grp[1], "gflops": grp[2],
                         "policy": tail.get("merge_policy"),
                         "k1_launches": int(tail.get("k1_launches", 0))})
    return rows, skipped


def groups(path):
    """The backend display names the CSV's rows hold, in order of first
    appearance."""
    names = []
    with open(path) as f:
        for line in f:
            parts = _fields(line)
            if len(parts) < 9 or parts[0] in ("", "dataset") \
                    or parts[0].startswith("#"):
                continue
            for name in _groups_of(parts):
                if name not in names:
                    names.append(name)
    return names


def record(path, backend_pref):
    """The TPU package's statistics record for the first group of
    ``backend_pref`` each row holds."""
    rows, skipped = load_rows(path, backend_pref)
    r_skew = pearson([r["row_length_variation"] for r in rows],
                     [r["gflops"] for r in rows])
    r_lin = pearson([r["num_nonzeros"] for r in rows],
                    [r["avg_ms"] for r in rows])
    # auxiliary: log-space linearity.  The raw Pearson (the paper's
    # anchor metric) is dominated by the worst few rows when the per-nnz
    # rate spans orders of magnitude; the log-log correlation reads
    # size-scaling across all classes on equal footing.
    r_log = pearson([math.log(r["num_nonzeros"]) for r in rows
                     if r["avg_ms"] > 0],
                    [math.log(r["avg_ms"]) for r in rows
                     if r["avg_ms"] > 0])
    return {
        "rows_used": len(rows),
        "rows_skipped": [s[0] for s in skipped],
        "corr_gflops_vs_row_cov": (None if r_skew is None
                                   else round(r_skew, 3)),
        "corr_runtime_vs_nnz": (None if r_lin is None
                                else round(r_lin, 3)),
        "corr_log_runtime_vs_log_nnz": (None if r_log is None
                                        else round(r_log, 3)),
        "reference": dict(REFERENCE),
    }


def _hmean(xs):
    return len(xs) / sum(1.0 / x for x in xs) if xs else None


def speedups(path, merge_name, library_name):
    """Merge against the library over the rows both timed: per row the
    library's ``avg_ms`` over merge's (above 1, merge is faster)."""
    m_rows, _ = load_rows(path, (merge_name,))
    l_rows, _ = load_rows(path, (library_name,))
    lib = {r["dataset"]: r for r in l_rows}
    pairs = []
    for r in m_rows:
        o = lib.get(r["dataset"])
        if o is None or r["avg_ms"] <= 0 or o["avg_ms"] <= 0:
            continue
        pairs.append({"dataset": r["dataset"],
                      "num_nonzeros": int(r["num_nonzeros"]),
                      "row_length_variation": r["row_length_variation"],
                      "policy": r["policy"], "merge_ms": r["avg_ms"],
                      "library_ms": o["avg_ms"],
                      "speedup": o["avg_ms"] / r["avg_ms"]})
    ratios = [p["speedup"] for p in pairs]
    by_policy = {}
    for p in pairs:
        by_policy.setdefault(str(p["policy"]), []).append(p["speedup"])
    large = [p["speedup"] for p in pairs if p["num_nonzeros"] > LARGE_NNZ]
    return {
        "merge": merge_name, "library": library_name,
        "rows_both": len(pairs),
        "hmean_speedup": _hmean(ratios),
        "rows_above_300k_nnz": len(large),
        "hmean_speedup_above_300k_nnz": _hmean(large),
        "median_speedup": statistics.median(ratios) if ratios else None,
        "min_speedup": min(ratios) if ratios else None,
        "max_speedup": max(ratios) if ratios else None,
        "rows_merge_faster": sum(x > 1.0 for x in ratios),
        "k1_launches": sum(r["k1_launches"] for r in m_rows),
        # merge's gather policy is picked per matrix (ops/plan.py)
        "by_policy": {pol: {"rows": len(xs), "hmean_speedup": _hmean(xs)}
                      for pol, xs in sorted(by_policy.items())},
        "worst": sorted(pairs, key=lambda p: p["speedup"])[:WORST],
        "reference": dict(SPEEDUP_REFERENCE),
    }


def _devices(path):
    notes = []
    with open(path) as f:
        for line in f:
            if line.startswith("# device:"):
                note = line.split(":", 1)[1].strip()
                if note not in notes:
                    notes.append(note)
    return notes


def main(argv=None):
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__)
        return 2
    out = {}
    for path in paths:
        rec = {"device": _devices(path)}
        names = groups(path)
        for name in names:
            r = record(path, (name,))
            rec[name] = r
            print(f"{path} [{name}]: n={r['rows_used']} "
                  f"skew_corr={r['corr_gflops_vs_row_cov']} "
                  f"linearity={r['corr_runtime_vs_nnz']} "
                  f"log_linearity={r['corr_log_runtime_vs_log_nnz']} "
                  f"skipped={r['rows_skipped']}")
        merge = next((n for n in MERGE_NAMES if n in names), None)
        library = next((n for n in LIBRARY_NAMES if n in names), None)
        if merge and library:
            s = speedups(path, merge, library)
            rec["merge_vs_library"] = s
            print(f"{path}: {library} avg_ms / {merge} avg_ms over "
                  f"{s['rows_both']} rows: harmonic mean "
                  f"{s['hmean_speedup']}, above 300K nnz "
                  f"{s['hmean_speedup_above_300k_nnz']} "
                  f"({s['rows_above_300k_nnz']} rows), median "
                  f"{s['median_speedup']}, merge faster on "
                  f"{s['rows_merge_faster']}, K1 launches "
                  f"{s['k1_launches']}; worst: "
                  + "; ".join(f"{w['dataset']} {w['speedup']:.3f} "
                              f"({w['policy']}, CoV "
                              f"{w['row_length_variation']:g})"
                              for w in s["worst"]))
        out[os.path.basename(path)] = rec
    if len(paths) == 1:
        dst = os.path.join(os.path.dirname(os.path.abspath(paths[0])),
                           "CORPUS_STATS.json")
        with open(dst, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
