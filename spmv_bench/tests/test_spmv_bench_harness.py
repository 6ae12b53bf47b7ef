"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped; the operators run their plain versions): a sound run
is correct, and the control and each fault a cell can have come out not
correct under the committed limits."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from spmv_bench import control, run, system

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 4242
STENCIL = {"generator": "stencil27", "dtype": "float64",
           "entry": "build_operator",
           "params": {"nx": 10, "ny": 9, "nz": 8, "diagonal": 26.0,
                      "off_diagonal": -1.0}}
RMAT = {"generator": "rmat", "dtype": "float64", "entry": "build_operator",
        "params": {"scale": 9, "nnz": 6000, "a": 0.57, "b": 0.19,
                   "c": 0.19, "values": [-1.0, 1.0]}}
RMAT32 = dict(RMAT, dtype="float32")
# case -> (cell, configuration, changes to the cell's traffic, limits or
# None for the cell's own); "spmv_k8" drives the chain's k right-hand
# sides (op.mm), which no committed mix uses yet; "spmv_k130_f32" drives
# op.mm in float32 past K1m's 64 columns a launch.  Its product_err,
# in float32's unit roundoff, read 0.98-1.53 under the program and
# 1.21e5-1.26e5 under the bfloat16 control on three seeds on the CPU.
TINY = {
    "spmv": ("kron_g500_logn21.spmv", RMAT, {}, None),
    "spmv_k8": ("kron_g500_logn21.spmv", RMAT, {"k": 8}, None),
    "spmv_k130_f32": ("kron_g500_logn21.spmv", RMAT32, {"k": 130},
                      {"product_err": 1024.0}),
    "cg": ("hpcg_104.cg", STENCIL, {}, None),
}


def tiny_run(case, sut, trace=False, seconds=0.3):
    cell, config, change, limits = TINY[case]
    traffic = run.find_cell(run.load_benchmark(), cell)[2]
    traffic.update(change)
    if trace:
        traffic.update(trace_after_s=0.0, trace_calls=4, trace_sets=1)
    return run.run_cell(cell, SEED, seconds, trace, "cpu", sut,
                        time.perf_counter(), config=config, traffic=traffic,
                        limits=limits)


@pytest.mark.parametrize("case", sorted(TINY))
def test_sound_run_is_correct(case):
    result = tiny_run(case, system.Program())
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    e2e, _ = run.cell_metrics(run.load_benchmark(), TINY[case][0])
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("case", sorted(TINY))
def test_traced_run_is_correct_and_reads_the_program_spans(case):
    result = tiny_run(case, system.Program(), trace=True)
    assert result["correct"]
    assert {"setup_plan_s", "setup_prepare_s"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("case", sorted(TINY))
def test_control_is_not_correct(case):
    result = tiny_run(case, control.Control())
    assert not result["correct"]


@pytest.mark.parametrize("dtype,lower", [("float64", torch.float32),
                                         ("float32", torch.bfloat16)])
def test_control_runs_one_precision_below_the_configuration(dtype, lower):
    assert control.LOWER[dtype] == lower
    host = {"num_rows": 2, "num_cols": 2, "row_offsets": [0, 1, 2],
            "col_indices": [0, 1], "values": [1.0, 3.0]}
    op = control.Control().build(host, {"dtype": dtype}, "cpu")
    assert op.lower == lower
    x = torch.tensor([1.0, 1.0 + 2.0 ** -12], dtype=torch.float64)
    # 3 (1 + 2^-12) is exact in float32 and rounds in bfloat16
    exact = float(op(x)[1]) == 3.0 * (1.0 + 2.0 ** -12)
    assert exact == (lower == torch.float32)


def test_control_refuses_a_dtype_it_has_no_precision_below():
    with pytest.raises(KeyError):
        control.Control().build({"num_rows": 0, "num_cols": 0,
                                 "row_offsets": [0], "col_indices": [],
                                 "values": []}, {"dtype": "bfloat16"}, "cpu")


class FaultyOperator:
    """The program's operator with a fault planted in what it returns."""

    def __init__(self, op, fault):
        self.op, self.fault = op, fault
        self.shape, self.device = op.shape, op.device
        self.dtype, self.setup_s = op.dtype, op.setup_s

    def _plant(self, x, y_in, y):
        if self.fault == "unchanged":       # the state returned unchanged
            return x.clone()
        y = y.clone()
        if self.fault == "altered":         # one answer altered
            flat = y.view(-1)
            i = int(flat.abs().argmax())
            flat[i] = flat[i] * (1 + 1e-9)
        elif self.fault == "half":          # half of the batch left out
            if y.dim() == 2:
                y[:, y.shape[1] // 2:] = 0 if y_in is None else \
                    y_in[:, y.shape[1] // 2:]
            else:
                y[y.shape[0] // 2:] = 0 if y_in is None else \
                    y_in[y.shape[0] // 2:]
        return y

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0):
        return self._plant(x, y_in, self.op(x, y_in, alpha, beta))

    def mm(self, X, Y_in=None, alpha=1.0, beta=0.0):
        return self._plant(X, Y_in, self.op.mm(X, Y_in, alpha, beta))


class Faulty(system.Program):
    def __init__(self, fault):
        self.fault = fault

    def build(self, host_csr, config, device):
        op = super().build(host_csr, config, device)
        return op if self.fault == "solution_altered" else \
            FaultyOperator(op, self.fault)

    def solve(self, solver, op, b, **kwargs):
        if self.fault == "stops_early":
            kwargs = dict(kwargs, maxiter=kwargs["maxiter"] // 2)
        x, *info = super().solve(solver, op, b, **kwargs)
        if self.fault == "solution_altered":   # the answer altered
            i = int(x.abs().argmax())
            x[i] = x[i] * (1 + 1e-6)
        return (x, *info)


@pytest.mark.parametrize("case,fault", [
    (case, fault) for case in sorted(TINY)
    for fault in ("unchanged", "half")] + [
    ("spmv", "altered"), ("spmv_k8", "altered"),
    ("cg", "solution_altered"), ("cg", "stops_early")])
def test_each_fault_is_not_correct(case, fault):
    result = tiny_run(case, Faulty(fault))
    assert not result["correct"], (case, fault, result["checks"])


def _cli(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "spmv_bench/run.py", "--workload",
         "hpcg_104.cg", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_without_a_card_exits_nonzero_and_prints_no_result():
    proc = _cli(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "spmv_bench", tmp_path / "spmv_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    proc = subprocess.run(
        [sys.executable, "-c", "import spmv_bench.system as s; "
         "s.Program().build({}, {}, 'cpu')"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "merge_spmv_tpu_torch" in proc.stderr


@pytest.mark.cuda
def test_alpha_has_the_same_bits_on_every_call_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from spmv_bench import reference
    from spmv_bench.generators import rmat
    csr = rmat.generate({"scale": 18, "nnz": 8_000_000, "a": 0.57,
                         "b": 0.19, "c": 0.19, "values": [-1.0, 1.0]},
                        SEED, "cuda")
    first = reference.max_row_abs_sum(csr)
    assert all(reference.max_row_abs_sum(csr) == first for _ in range(5))
    assert json.dumps(first)


def test_cg_reports_the_median_set_and_the_mean_per_layer():
    from types import SimpleNamespace

    from spmv_bench.loops import cg_sets

    loop = object.__new__(cg_sets.Loop)
    loop.sets = [{"host_ms": ms, "traced": traced}
                 for ms, traced in [(30.0, False), (29.0, False),
                                    (400.0, False), (31.0, False),
                                    (90.0, True)]]
    assert loop.end_to_end() == {"solve_p50_ms": 31.0}
    mean = run.reader("solve_mean_ms").read(SimpleNamespace(loop=loop))
    assert mean == (30.0 + 29.0 + 400.0 + 31.0) / 4
