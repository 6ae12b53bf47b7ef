"""The FastRP cell, kron_g500_logn21_sym.fastrp, on the CPU at a tiny size:
its generator, its reference against dense arithmetic, whole runs through
the program (correct) and through the bfloat16 control and planted faults
(not correct), and the readers of its per-layer metrics."""

import time
from types import SimpleNamespace

import pytest
import torch

from spmv_bench import control, reference_fastrp, run, system
from spmv_bench.generators import rmat_sym
from spmv_bench.loops import fastrp as fastrp_loop
from spmv_bench.trace import Trace

CELL = "kron_g500_logn21_sym.fastrp"
SEED = 2 ** 31 + 4242
TINY = {"generator": "rmat_sym", "dtype": "float32",
        "entry": "transition_operator",
        "params": {"scale": 11, "edges": 12000, "a": 0.57, "b": 0.19,
                   "c": 0.19}}
NEW = ["k1m_roofline.fastrp", "device_idle_pct.fastrp", "mm_host_us.fastrp",
       "fastrp_normalize_us", "fastrp_dense_pct"]


def tiny_run(sut, trace=False, seconds=0.3, **change):
    traffic = run.find_cell(run.load_benchmark(), CELL)[2]
    traffic.update(change)
    if trace:
        traffic.update(trace_after_s=0.0, trace_calls=2)
    return run.run_cell(CELL, SEED, seconds, trace, "cpu", sut,
                        time.perf_counter(), config=TINY, traffic=traffic)


def test_rmat_sym_is_symmetric_twice_the_edges_and_seeded():
    csr = rmat_sym.generate(TINY["params"], SEED, "cpu")
    n = csr["num_rows"]
    assert n == csr["num_cols"] == 2048
    assert csr["values"].numel() == 2 * TINY["params"]["edges"]
    assert bool((csr["values"] == 1.0).all())
    offsets = csr["row_offsets"]
    rows = torch.repeat_interleave(torch.arange(n), offsets[1:] - offsets[:-1])
    cols = csr["col_indices"].long()
    keys = rows * n + cols
    assert bool((keys[1:] >= keys[:-1]).all())
    mirrored = torch.sort(cols * n + rows).values
    assert torch.equal(keys, mirrored)
    again = rmat_sym.generate(TINY["params"], SEED, "cpu")
    assert all(torch.equal(csr[k], again[k]) for k in
               ("row_offsets", "col_indices", "values"))
    other = rmat_sym.generate(TINY["params"], SEED + 1, "cpu")
    assert not torch.equal(csr["col_indices"], other["col_indices"])


def test_rmat_sym_mirrors_rmat_draws():
    """The edges are rmat.py's nonzeros at the same seed."""
    from spmv_bench.generators import rmat

    p = TINY["params"]
    half = rmat.generate({"scale": p["scale"], "nnz": p["edges"], "a": p["a"],
                          "b": p["b"], "c": p["c"], "values": [1.0, 1.0]},
                         SEED, "cpu")
    sym = rmat_sym.generate(p, SEED, "cpu")
    n = sym["num_rows"]

    def pairs(csr):
        o = csr["row_offsets"]
        r = torch.repeat_interleave(torch.arange(n), o[1:] - o[:-1])
        return r * n + csr["col_indices"].long()

    h = pairs(half)
    both = torch.sort(torch.cat([h, (h % n) * n + h // n])).values
    assert torch.equal(both, pairs(sym))


def dense_fastrp(csr, r, weights):
    n = csr["num_rows"]
    a = torch.zeros(n, csr["num_cols"], dtype=torch.float64)
    o = csr["row_offsets"]
    rows = torch.repeat_interleave(torch.arange(n), o[1:] - o[:-1])
    a.index_put_((rows, csr["col_indices"].long()),
                 csr["values"].double(), accumulate=True)
    sums = a.sum(1, keepdim=True)
    p = torch.where(sums > 0, a / torch.where(sums > 0, sums, 1.0), 0.0)
    x, emb = r.double(), torch.zeros(n, r.shape[1], dtype=torch.float64)
    for w in weights:
        x = p @ x
        norms = x.norm(dim=1, keepdim=True)
        x = torch.where(norms > 0, x / torch.where(norms > 0, norms, 1.0), 0.)
        emb = emb + w * x
    return emb


@pytest.mark.parametrize("weights", [(0.0, 1.0, 1.0), (0.5, 1.0, 0.0, 2.0)])
def test_reference_agrees_with_dense_fastrp(weights):
    params = dict(TINY["params"], scale=8, edges=900)
    csr = rmat_sym.generate(params, SEED, "cpu")
    r = torch.randn(csr["num_cols"], 70, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    got = reference_fastrp.fastrp(csr, r, weights)
    want = dense_fastrp(csr, r, weights)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-13
    empty = csr["row_offsets"][1:] == csr["row_offsets"][:-1]
    assert bool(empty.any()) and bool((got[empty] == 0).all())


def test_projection_is_very_sparse_and_seeded():
    cell = SimpleNamespace(seed=SEED, problem={"num_cols": 4096,
                                               "dtype": "float32"},
                           traffic={"k": 64, "projection_pool": 2})
    pool = fastrp_loop.projections(cell, "cpu")
    assert len(pool) == 2 and pool[0].shape == (4096, 64)
    assert pool[0].dtype == torch.float32
    root = torch.tensor(3.0 ** 0.5, dtype=torch.float32)
    assert set(pool[0].unique().tolist()) == {-float(root), 0.0, float(root)}
    share = float((pool[0] != 0).double().mean())
    assert abs(share - 1 / 3) < 0.01
    assert not torch.equal(pool[0], pool[1])
    again = fastrp_loop.projections(cell, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pool, again))


def test_sound_run_is_correct():
    result = tiny_run(system.Program())
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"spmv_gflops", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["checks"]["embedding_err"]["value"] <= \
        result["checks"]["embedding_err"]["limit"]


def test_traced_run_reads_the_program_spans():
    result = tiny_run(system.Program(), trace=True)
    assert result["correct"]
    # the card's readings (K1m's share, the dense share) need device
    # activities, which a CPU trace has not
    assert {"mm_host_us.fastrp", "fastrp_normalize_us",
            "device_idle_pct.fastrp"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0
    # the build's spans: the transition's scaling lies inside "prepare"
    assert {"setup_plan_s", "setup_prepare_s"} <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] > 0
               for m in ("setup_plan_s", "setup_prepare_s"))


class FastrpControl(control.Control):
    """The control for FastRP: the reference in bfloat16 (``LOWER`` of
    float32) in the program's place."""

    def solve(self, solver, op, b, iteration_weights=(0.0, 1.0, 1.0), **_):
        emb = reference_fastrp.fastrp(op.csr, b, iteration_weights, op.lower)
        return emb, len(iteration_weights), 0, None


def test_bfloat16_control_is_not_correct():
    result = tiny_run(FastrpControl())
    assert not result["correct"]
    check = result["checks"]["embedding_err"]
    assert check["value"] > 10 * check["limit"]


class Faulty(system.Program):
    def __init__(self, fault):
        self.fault = fault

    def solve(self, solver, op, b, **kwargs):
        if self.fault == "stops_early":     # a product left out
            kwargs = dict(kwargs, iteration_weights=(1.0, 1.0))
        emb, *info = super().solve(solver, op, b, **kwargs)
        if self.fault == "unchanged":       # the projection returned
            emb = b.clone()
        elif self.fault == "altered":       # one answer altered
            flat = emb.view(-1)
            i = int(flat.abs().argmax())
            flat[i] = flat[i] + 1e-3
        elif self.fault == "half":          # half of the columns left out
            emb[:, emb.shape[1] // 2:] = 0
        return (emb, *info)


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half",
                                   "stops_early"])
def test_each_fault_is_not_correct(fault):
    result = tiny_run(Faulty(fault))
    assert not result["correct"], (fault, result["checks"])


def test_traced_products_count_three_a_call():
    calls = []

    class Counting(system.Program):
        def solve(self, *args, **kwargs):
            out = super().solve(*args, **kwargs)
            calls.append(out[1])
            return out

    tiny_run(Counting(), trace=True)
    assert set(calls) == {3}
    traffic = run.find_cell(run.load_benchmark(), CELL)[2]
    traffic.update(trace_after_s=0.0, trace_calls=2)
    cell = run.Cell(CELL, TINY, traffic, {"embedding_err": 1.0}, SEED, "cpu",
                    {"num_rows": 2048, "num_cols": 2048, "nnz": 24000,
                     "dtype": "float32"})
    csr = rmat_sym.generate(TINY["params"], SEED, "cpu")
    op = system.Program().build(run.host_csr(csr), TINY, "cpu")
    loop = fastrp_loop.Loop(system.Program(), op, cell)
    loop.run(0.2, True)
    assert loop.traced_products == 3 * 2
    assert loop.products == 3 * loop.calls


def test_new_readers_state_layer_unit_and_source():
    bench = {m["name"]: m for m in run.load_benchmark()["per_layer"]}
    for name in NEW:
        module = run.reader(name)
        m = bench[name]
        assert (module.LAYER, module.UNIT, module.SOURCE) == \
            (m["layer"], m["unit"], m["source"])
        assert m["moves"] == "spmv_gflops" and m["workloads"] == [CELL]


def _record(device, host, products=6):
    trace = Trace(start=0.0, end=1.0, device=device, host=host)
    cell = SimpleNamespace(
        problem={"num_rows": 1 << 21, "num_cols": 1 << 21,
                 "nnz": 182082942, "dtype": "float32"},
        traffic={"k": 256, "beta": 0.0})
    return SimpleNamespace(trace=trace, cell=cell,
                           loop=SimpleNamespace(traced_products=products),
                           device_name="NVIDIA H100 80GB HBM3")


def test_readers_on_a_trace():
    k1m = "void merge_tile_mm_kernel<float, 2, true, 32>"
    device = [(k1m, 0.0, 0.2), (k1m, 0.25, 0.45), ("reduce_kernel", 0.5, 0.6),
              ("vectorized_elementwise_kernel", 0.6, 0.65)]
    host = [("merge_spmv.op.mm", 0.0, 0.0001), ("merge_spmv.op.mm", 0.3,
                                                0.3003),
            ("merge_spmv.solve.normalize", 0.4, 0.4005)]
    rec = _record(device, host)
    assert run.reader("fastrp_dense_pct").read(rec) == \
        pytest.approx(100 * 0.15 / 0.55)
    assert run.reader("mm_host_us.fastrp").read(rec) == pytest.approx(200.0)
    assert run.reader("fastrp_normalize_us").read(rec) == \
        pytest.approx(500.0)
    assert run.reader("device_idle_pct.fastrp").read(rec) == \
        pytest.approx(45.0)
    # 6 products of 5.76e9 bytes at 3.35e12 B/s over K1m's 0.4 s
    bytes_ = 182082942 * 8 + (1 << 21) * 4 + 2 * (1 << 21) * 256 * 4
    assert run.reader("k1m_roofline.fastrp").read(rec) == \
        pytest.approx(100 * 6 * bytes_ / 3.35e12 / 0.4)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_what_they_read(name):
    empty = _record([("reduce_kernel", 0.0, 0.1)], [])
    if name == "device_idle_pct.fastrp":
        assert run.reader(name).read(_record([], [], 6)) == 100.0
    else:
        assert run.reader(name).read(empty) is None
    assert run.reader(name).read(SimpleNamespace(trace=None)) is None
