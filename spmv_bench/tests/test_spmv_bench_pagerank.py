"""The PageRank cell, graph500_24.pagerank, on the CPU at a tiny size:
whole runs through the program (correct), through the float32 control
and through planted faults (not correct, under the committed limits),
the loop's counts, and the readers of its new per-layer metrics."""

import time
from types import SimpleNamespace

import pytest
import torch

from spmv_bench import control, reference_pagerank, run, system
from spmv_bench.generators import graph500, rmat
from spmv_bench.loops import pagerank_sets
from spmv_bench.trace import Trace

CELL = "graph500_24.pagerank"
SEED = 2 ** 31 + 2424
TINY = {"generator": "graph500", "dtype": "float64",
        "entry": "pagerank_operator",
        "params": {"scale": 10, "edgefactor": 16, "a": 0.57, "b": 0.19,
                   "c": 0.19}}
# a directed graph with dangling vertices (empty rows): rmat.py's draws
DIRECTED = dict(TINY, generator="rmat",
                params={"scale": 10, "nnz": 6000, "a": 0.57, "b": 0.19,
                        "c": 0.19, "values": [1.0, 1.0]})


NEW = ["k1_roofline.pagerank", "device_idle_pct.pagerank",
       "cg_masked_step_pct.pagerank", "pagerank_dense_pct",
       "setup_stochastic_s", "cg_eager_ms.pagerank",
       "cg_launches_per_step.pagerank", "cg_flag_read_ms.pagerank",
       "call_host_us.pagerank", "solve_p95_ms.pagerank"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """A job is ~200 small torch ops: one intra-op thread, so that idle
    threads spinning after an op do not compete with them on a loaded CPU
    (the setting is restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_run(sut, trace=False, seconds=0.3, config=TINY):
    traffic = run.find_cell(run.load_benchmark(), CELL)[2]
    traffic.update(warm_sets=1)
    if trace:   # untraced jobs first, for the counters' reader
        traffic.update(trace_after_s=0.15, trace_sets=2)
    return run.run_cell(CELL, SEED, seconds, trace, "cpu", sut,
                        time.perf_counter(), config=config, traffic=traffic)


@pytest.mark.parametrize("config", [TINY, DIRECTED])
def test_sound_run_is_correct(config):
    result = tiny_run(system.Program(), config=config)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"solve_p50_ms", "setup_s"}
    assert set(result["checks"]) == {"rank_err", "iteration_gap"}
    assert result["checks"]["rank_err"]["value"] <= 1e-14
    assert result["checks"]["iteration_gap"]["value"] == 0


def test_directed_graph_has_dangling_vertices():
    csr = rmat.generate(DIRECTED["params"], SEED, "cpu")
    empty = csr["row_offsets"][1:] == csr["row_offsets"][:-1]
    assert int(empty.sum()) >= 100
    ranks = reference_pagerank.pagerank(csr, 0.85, 10)
    # the rank the dangling vertices hold is a share the check can see
    assert float(ranks[empty].sum()) > 0.05


def test_traced_run_reads_the_program_spans_and_counters():
    result = tiny_run(system.Program(), trace=True, seconds=0.6)
    assert result["correct"]
    metrics = result["metrics"]
    # K1's share, the dense share and the launches a step need device
    # activities, which a CPU trace has not
    assert {"setup_stochastic_s", "setup_plan_s", "setup_prepare_s",
            "device_idle_pct.pagerank", "cg_masked_step_pct.pagerank",
            "cg_eager_ms.pagerank", "cg_flag_read_ms.pagerank",
            "call_host_us.pagerank", "solve_p95_ms.pagerank"} <= set(metrics)
    assert metrics["cg_masked_step_pct.pagerank"]["value"] == 37.5
    # one eager block and one flag read a job, 16 calls into P in it
    assert 0 < metrics["cg_flag_read_ms.pagerank"]["value"] < \
        metrics["cg_eager_ms.pagerank"]["value"]
    assert metrics["call_host_us.pagerank"]["value"] > 0
    assert metrics["solve_p95_ms.pagerank"]["value"] > 0
    assert 0 < metrics["setup_stochastic_s"]["value"] <= \
        metrics["setup_prepare_s"]["value"]


class PagerankControl(control.Control):
    """The control for PageRank: the reference in float32 (``LOWER`` of
    float64) on the adjacency CSR, in the program's place."""

    def solve(self, solver, op, damping, tol=0.0, maxiter=10, **_):
        pr = reference_pagerank.pagerank(op.csr, damping, maxiter, op.lower)
        return pr, int(maxiter), 1, None


def test_float32_control_is_not_correct():
    result = tiny_run(PagerankControl())
    assert not result["correct"]
    check = result["checks"]["rank_err"]
    assert check["value"] > 100 * check["limit"]


class Faulty(system.Program):
    def __init__(self, fault):
        self.fault = fault

    def build(self, host_csr, config, device):
        if self.fault == "row_stochastic":      # D^-1 A in P's place
            config = dict(config, entry="transition_operator")
        elif self.fault == "float32":           # the operator in float32
            config = dict(config, dtype="float32")
        return super().build(host_csr, config, device)

    def solve(self, solver, op, damping, **kwargs):
        if self.fault == "damping":
            damping = 0.9
        if self.fault == "no_dangling":         # the dangling rank lost
            n = op.shape[0]
            pr = torch.full((n,), 1.0 / n, dtype=torch.float64)
            for _ in range(kwargs["maxiter"]):
                pr = damping * op(pr) + (1.0 - damping) / n
            return pr, kwargs["maxiter"], 1, None
        return super().solve(solver, op, damping, **kwargs)


@pytest.mark.parametrize("fault,config", [("damping", TINY),
                                          ("no_dangling", DIRECTED),
                                          ("row_stochastic", TINY),
                                          ("float32", TINY)])
def test_each_fault_is_not_correct(fault, config):
    result = tiny_run(Faulty(fault), config=config)
    assert not result["correct"], (fault, result["checks"])
    assert result["checks"]["iteration_gap"]["value"] == 0


def test_a_job_asks_for_sixteen_products():
    """reads x check_every products a traced job, no prologue product;
    10 of the 16 steps do work."""
    traffic = run.find_cell(run.load_benchmark(), CELL)[2]
    traffic.update(trace_after_s=0.0, trace_sets=2)
    cell = run.Cell(CELL, TINY, traffic, {"rank_err": 1.0,
                                          "iteration_gap": 0}, SEED, "cpu")
    csr = graph500.generate(TINY["params"], SEED, "cpu")
    op = system.Program().build(run.host_csr(csr), TINY, "cpu")
    loop = pagerank_sets.Loop(system.Program(), op, cell)
    loop.run(0.2, True)
    traced = [s for s in loop.sets if s["traced"]]
    assert len(traced) == 2
    assert all(s["reads"] == 1 and s["iterations"] == 10 for s in loop.sets)
    assert loop.traced_products == 2 * 16
    assert loop.samples and loop.samples[0][0] == 0


def test_new_readers_state_layer_unit_and_source():
    bench = {m["name"]: m for m in run.load_benchmark()["per_layer"]}
    for name in NEW:
        module = run.reader(name)
        m = bench[name]
        assert (module.LAYER, module.UNIT, module.SOURCE) == \
            (m["layer"], m["unit"], m["source"])
        assert m["workloads"] == [CELL]
        assert m["moves"] == ("setup_s" if name == "setup_stochastic_s"
                              else "solve_p50_ms")


def _record(device, spans=None, products=32):
    trace = Trace(start=0.0, end=1.0, device=device, host=[])
    cell = SimpleNamespace(
        problem={"num_rows": 8871963, "num_cols": 8871963,
                 "nnz": 520757360, "dtype": "float64"},
        traffic={"solver_args": {"check_every": 16}})
    return SimpleNamespace(trace=trace, cell=cell, spans=spans or {},
                           loop=SimpleNamespace(traced_products=products,
                                                sets=[]),
                           device_name="NVIDIA H100 80GB HBM3")


def test_readers_on_a_trace():
    k1 = "void merge_tile_kernel<double, true, 1>"
    device = [(k1, 0.0, 0.4), (k1, 0.45, 0.85), ("reduce_kernel", 0.85, 0.9),
              ("vectorized_elementwise_kernel", 0.9, 0.95)]
    rec = _record(device, {"stochastic": 0.291, "prepare": 1.386})
    assert run.reader("pagerank_dense_pct").read(rec) == \
        pytest.approx(100 * 0.1 / 0.9)
    assert run.reader("setup_stochastic_s").read(rec) == 0.291
    assert run.reader("device_idle_pct.pagerank").read(rec) == \
        pytest.approx(10.0)
    # 32 products of A (8 B a value, 4 a column, 4 a row end), x and y at
    # 3.35e12 B/s over K1's 0.8 s
    bytes_ = 520757360 * 12 + 8871963 * (4 + 8 + 8)
    assert run.reader("k1_roofline.pagerank").read(rec) == \
        pytest.approx(100 * 32 * bytes_ / 3.35e12 / 0.8)


@pytest.mark.parametrize("name", ["pagerank_dense_pct", "setup_stochastic_s",
                                  "k1_roofline.pagerank"])
def test_readers_give_none_without_what_they_read(name):
    """No K1 launch, no stochastic span (the parent's program), no
    trace."""
    empty = _record([("reduce_kernel", 0.0, 0.1)])
    assert run.reader(name).read(empty) is None
    if name != "setup_stochastic_s":
        assert run.reader(name).read(SimpleNamespace(trace=None)) is None
