"""Run one cell of the benchmark and print its result line.

    python3 spmv_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  A run:

1. finds the cell in ``BENCHMARK.json``; its configuration's file names
   the generator (``generators/<name>.py``) and the entry of
   merge_spmv_tpu_torch that builds the operator, its traffic mix
   ``traffic/<mix>.json`` names the timed loop (``loops/<loop>.py``), and
   ``limits/<cell>.json`` holds the limits of the comparison;
2. generates the matrix on the card from ``--seed``, hands the program a
   host CSR of it (the entry takes no other), and warms the cell's shapes;
   ``setup_s`` runs from the process's start to the window's;
3. runs the loop for ``--seconds``; with ``--trace 1`` a short sub-window
   of it runs under ``torch.profiler`` and the per-layer metrics are read
   from it and from the program's spans (``metrics/<metric>.py``);
4. frees the program's state, generates the matrix again and holds the
   sampled outputs to the plain reference (``reference.py``);
5. prints each number compared beside its limit as the last lines of
   standard error, and the result as the last line of standard output.

It exits with 3 and prints no result without the cards, and with 4 when
a module of JAX or of the JAX package is loaded after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "spmv_bench"
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from spmv_bench import reference  # noqa: E402

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "merge_spmv_tpu")
PROGRAM_BUILD = ROOT / "merge_spmv_tpu_torch" / "build"


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: str
    problem: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, workload: str):
    """(workload entry, configuration, traffic, limits) of ``workload``."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return (entry, load_json(ROOT / conf["file"]),
            load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
            load_json(BENCH_DIR / "limits" / f"{workload}.json"))


def cell_metrics(bench: dict, workload: str):
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def reader(name: str):
    """The reader module of per-layer metric ``name``:
    ``metrics/<name>.py``, or else the file of the name before its first
    dot, which serves every cell's entry of the quantity."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"spmv_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def host_csr(csr: dict) -> dict:
    """The generated CSR on the host, as the program's entry takes it."""
    return {"num_rows": csr["num_rows"], "num_cols": csr["num_cols"],
            "row_offsets": csr["row_offsets"].to(torch.int32).cpu().numpy(),
            "col_indices": csr["col_indices"].cpu().numpy(),
            "values": csr["values"].cpu().numpy()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, system, t_start: float, bench=None,
             config=None, traffic=None, limits=None) -> dict:
    """One run of ``workload``; returns the result (see ``main``).
    ``config``, ``traffic`` and ``limits`` replace what the files give
    (the tests' sizes)."""
    bench = bench or load_benchmark()
    entry, conf_f, traffic_f, limits_f = find_cell(bench, workload)
    cell = Cell(workload, config or conf_f, traffic or traffic_f,
                limits or limits_f, int(seed), device)
    generate = importlib.import_module(
        f"spmv_bench.generators.{cell.config['generator']}").generate
    cuda = torch.device(device).type == "cuda"

    csr = generate(cell.config["params"], cell.seed, device)
    cell.problem = {"num_rows": csr["num_rows"], "num_cols": csr["num_cols"],
                    "nnz": int(csr["values"].numel()),
                    "dtype": cell.config["dtype"],
                    "max_row_abs_sum": reference.max_row_abs_sum(csr)}
    host = host_csr(csr)
    del csr
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    built_before = set(PROGRAM_BUILD.glob("*.so"))
    op = system.build(host, cell.config, device)
    del host
    loop = importlib.import_module(
        f"spmv_bench.loops.{cell.traffic['loop']}").Loop(system, op, cell)
    loop.warm()
    setup_s = time.perf_counter() - t_start

    loop.run(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    built = sorted(p.name for p in set(PROGRAM_BUILD.glob("*.so"))
                   - built_before)
    spans = system.setup_spans(op)
    e2e_values = loop.end_to_end()
    e2e_values["setup_s"] = setup_s
    loop.release()
    del op
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers, failed = loop.check(generate(cell.config["params"], cell.seed,
                                          device))
    checks = {name: {"value": value, "limit": cell.limits[name]}
              for name, value in numbers.items()}
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    e2e, per_layer = cell_metrics(bench, workload)
    if trace:
        record = SimpleNamespace(cell=cell, loop=loop, trace=loop.trace,
                                 spans=spans,
                                 device_name=torch.cuda.get_device_name(
                                     device) if cuda else "cpu")
        metrics = {}
        for m in per_layer:
            value = reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e_values[m["name"]],
                               "unit": m["unit"]} for m in e2e}
    result = {"correct": bool(correct), "attempted": loop.attempted,
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device)
                         if cuda else "cpu",
                         "count": int(entry["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if cuda:
        result["device"]["device_count"] = torch.cuda.device_count()
        result["device"]["power_limit"] = power_limit()
    if trace and loop.trace is not None:
        result["device"]["busy_s"] = loop.trace.busy_s()
        result["device"]["window_s"] = loop.trace.window_s
        result["breakdown"] = {"device_ops": loop.trace.device_ops(),
                               "idle_gaps": loop.trace.idle_gaps()}
    result["built"] = built
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_benchmark()
    entry = find_cell(bench, args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from spmv_bench.system import Program

    importlib.import_module("merge_spmv_tpu_torch")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", Program(), T_START, bench)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"built this run: {result['built'] or 'nothing'}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{verdict}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
