"""The per-phase split of a cell's traced sub-window, from the program's
spans: what the per-layer metrics sum, taken apart.

    python3 spmv_bench/span_split.py --workload hpcg_104.cg --seed <n> \\
        --seconds <s> [--out <file.json>]

Runs the cell as ``run.py --trace 1`` does, then prints, for each traced
solve, its host ms in each ``merge_spmv.solve.*`` phase, the device's
idle ms under each, how many spans of each it holds beside its host
reads, and the share of the solve span its phases cover; the median host
time of the traced and the untraced sets; the ``merge_spmv.op.call``
spans' count and host time; and any ``merge_spmv.`` name on the device
timeline (there should be none).  ``--out`` writes it as JSON too.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

from spmv_bench import run, spans  # noqa: E402


def split(trace, sets):
    """One row a traced solve, by phase."""
    idle = spans.idle(trace)
    traced = [s for s in sets if s["traced"]]
    rows = []
    for i, phases in enumerate(spans.solves(trace)):
        (s0, e0), = phases[spans.SOLVE]
        inner = spans.union(iv for name, ivs in phases.items()
                            if name != spans.SOLVE for iv in ivs)
        row = {"solve_ms": 1e3 * (e0 - s0),
               "idle_ms": 1e3 * spans.overlap(idle, [[s0, e0]]),
               "covered_pct": 100 * sum(e - s for s, e in inner) / (e0 - s0),
               "host_reads": traced[i]["reads"] if i < len(traced) else None}
        for name, ivs in sorted(phases.items()):
            if name != spans.SOLVE:
                row[name[len(spans.PHASE):]] = {
                    "n": len(ivs), "ms": 1e3 * sum(e - s for s, e in ivs),
                    "idle_ms": 1e3 * spans.overlap(idle, spans.union(ivs))}
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from spmv_bench.system import Program

    # keep the record run_cell hands its readers: it holds the loop and
    # its trace
    kept, reader = {}, run.reader

    def keeping(name):
        def read(record):
            kept["record"] = record
            return reader(name).read(record)
        return SimpleNamespace(read=read)

    run.reader = keeping
    result = run.run_cell(args.workload, args.seed, args.seconds, True,
                          "cuda", Program(), T_START)
    record = kept["record"]
    trace, sets = record.trace, record.loop.__dict__.get("sets", [])
    calls = [e - s for s, e in spans.named(trace, spans.OP_CALL)]
    out = {"workload": args.workload, "seed": args.seed,
           "device": result["device"], "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "solves": split(trace, sets),
           "host_ms": {k: statistics.median(s["host_ms"] for s in sets
                                            if s["traced"] == traced)
                       for k, traced in (("traced", True),
                                         ("untraced", False))
                       if any(s["traced"] == traced for s in sets)},
           "op_call": {"n": len(calls),
                       "median_us": 1e6 * statistics.median(calls)
                       if calls else None},
           "device_span_names": sorted({n for n, _, _ in trace.device
                                        if n.startswith("merge_spmv.")})}
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
