"""The readers of the program's spans and counters: a synthetic Trace
whose host events hold nested merge_spmv.* spans over known device
intervals gives each its exact number, and a window without the spans
gives None.  A tiny traced CG run on the CPU reads them from the
program."""

import time
from types import SimpleNamespace

import pytest

from spmv_bench import run, spans, system
from spmv_bench.trace import Trace

SOLVE, P = "merge_spmv.solve", "merge_spmv.solve."
CALL = "merge_spmv.op.call"
NEW = ["cg_capture_ms", "cg_eager_ms", "cg_flag_read_ms",
       "cg_masked_step_pct", "cg_idle_unspanned_pct", "call_host_us.spmv",
       "call_host_us.cg"]


def window():
    """Two sets in a 100 ms window; every phase span of a set abuts the
    next, so the phases cover 0-40 and 50-80 ms."""
    ms = 1e-3
    host = [
        (SOLVE, 0, 40), (P + "prologue", 0, 2), (CALL, 0.5, 0.6),
        (P + "eager_block", 2, 8), (CALL, 3, 3.1), (CALL, 5, 5.1),
        ("aten::mul", 5.5, 5.6), (P + "flag_read", 8, 10),
        (P + "capture", 10, 25), (P + "capture.enter", 10, 12),
        (P + "capture.record", 12, 22), (P + "capture.exit", 22, 25),
        (P + "replay", 25, 26), (P + "flag_read", 26, 36),
        (P + "replay", 36, 37), (P + "flag_read", 37, 40),
        (SOLVE, 50, 80), (P + "prologue", 50, 51),
        (P + "eager_block", 51, 55), (P + "flag_read", 55, 57),
        (P + "capture", 57, 67), (P + "replay", 67, 68),
        (P + "flag_read", 68, 80),
    ]
    device = [("merge_tile_kernel", 3, 7), ("merge_tile_kernel", 26, 36),
              ("elementwise_kernel", 68, 79)]
    return Trace(start=0.0, end=100 * ms,
                 host=[(n, s * ms, e * ms) for n, s, e in host],
                 device=[(n, s * ms, e * ms) for n, s, e in device])


def record(trace, sets=()):
    return SimpleNamespace(
        trace=trace, loop=SimpleNamespace(sets=list(sets)),
        cell=SimpleNamespace(traffic={"solver_args": {"check_every": 16}}))


SETS = [{"iterations": 50, "reads": 4, "traced": False},
        {"iterations": 50, "reads": 4, "traced": False},
        {"iterations": 3, "reads": 1, "traced": True}]


@pytest.mark.parametrize("name,want", [
    ("cg_capture_ms", (15 + 10) / 2),
    ("cg_eager_ms", (6 + 4) / 2),
    ("cg_flag_read_ms", ((2 + 10 + 3) + (2 + 12)) / 2),
    ("call_host_us.spmv", 100.0),
    ("call_host_us.cg", 100.0),
    # idle 75 ms (busy 4 + 10 + 11), of it unspanned 40-50 and 80-100
    ("cg_idle_unspanned_pct", 100.0 * 30 / 75),
    ("cg_masked_step_pct", 100.0 * (1 - 100 / 128)),
])
def test_each_reader_gives_its_exact_number(name, want):
    assert run.reader(name).read(record(window(), SETS)) == \
        pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_none_without_its_spans(name):
    bare = window()
    bare.host = [h for h in bare.host if not h[0].startswith("merge_spmv")]
    assert run.reader(name).read(record(bare)) is None
    assert run.reader(name).read(record(None)) is None


def test_phases_belong_to_the_solve_that_holds_them():
    trace = window()
    trace.host.append((P + "flag_read", 0.09, 0.095))    # in no solve
    sets = spans.solves(trace)
    assert [len(s[P + "flag_read"]) for s in sets] == [3, 2]
    assert [len(s.get(P + "capture.enter", [])) for s in sets] == [1, 0]
    assert spans.phase_ms_per_solve(trace, P + "flag_read") == \
        pytest.approx(14.5)


def test_union_and_overlap():
    a = spans.union([(5, 7), (0, 2), (1, 3), (4, 4)])
    assert a == [[0, 3], [5, 7]]
    assert spans.overlap(a, spans.union([(2, 6)])) == 2
    assert spans.overlap(a, []) == 0


def stand_together(names, run_):
    """Whether ``run_`` stands in ``names`` as one stretch, in order."""
    return any(names[i:i + len(run_)] == run_
               for i in range(len(names) - len(run_) + 1))


def test_each_new_entry_is_in_the_benchmark():
    names = [m["name"] for m in run.load_benchmark()["per_layer"]]
    assert stand_together(names, NEW)


@pytest.mark.parametrize("case,holds", [
    ("as_committed", True),
    ("one_appended_after", True),
    ("one_put_before", True),
    ("first_dropped", False),
    ("middle_dropped", False),
    ("last_dropped", False),
    ("one_renamed", False),
    ("two_swapped", False),
    ("one_put_between", False),
])
def test_the_new_entries_must_stand_together_in_order(case, holds):
    names = ["setup_plan_s", "k1_roofline.cg"] + NEW
    lead = len(names) - len(NEW)
    if case == "one_appended_after":
        names.append("cg_launches_per_step")
    elif case == "one_put_before":
        names.insert(lead, "cg_launches_per_step")
    elif case.endswith("_dropped"):
        del names[{"first": lead, "middle": lead + 3,
                   "last": len(names) - 1}[case.split("_")[0]]]
    elif case == "one_renamed":
        names[lead + 2] = "cg_flag_reads_ms"
    elif case == "two_swapped":
        names[lead + 1], names[lead + 2] = names[lead + 2], names[lead + 1]
    elif case == "one_put_between":
        names.insert(lead + 4, "cg_launches_per_step")
    assert stand_together(names, NEW) == holds


def test_traced_cg_run_reads_the_program_spans_and_counters():
    """On the CPU the solver runs every block eagerly: no capture, one
    eager block and one flag read per host read, 14 of 64 steps masked
    (50 iterations in blocks of 16)."""
    traffic = run.find_cell(run.load_benchmark(), "hpcg_104.cg")[2]
    traffic.update(trace_after_s=0.3, trace_sets=1)
    config = {"generator": "stencil27", "dtype": "float64",
              "entry": "build_operator",
              "params": {"nx": 6, "ny": 5, "nz": 4, "diagonal": 26.0,
                         "off_diagonal": -1.0}}
    result = run.run_cell("hpcg_104.cg", 2 ** 31 + 77, 3.0, True, "cpu",
                          system.Program(), time.perf_counter(),
                          config=config, traffic=traffic)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"]
    assert m["cg_capture_ms"] == 0.0
    assert m["cg_eager_ms"] > 0 and m["cg_flag_read_ms"] > 0
    assert m["call_host_us.cg"] > 0
    assert m["cg_masked_step_pct"] == pytest.approx(100 * 14 / 64)
    assert 0 <= m["cg_idle_unspanned_pct"] < 100
    # the CPU's trace holds no device activity: read on the card
    assert m.get("cg_launches_per_step") in (None, 0)


def cg_loop(sets, check_every=16):
    from spmv_bench.loops import cg_sets

    loop = object.__new__(cg_sets.Loop)
    loop.sets = list(sets)
    loop.cell = SimpleNamespace(
        traffic={"solver_args": {"check_every": check_every}})
    return loop


def test_cg_counts_the_traced_products():
    """The prologue's product and every step of the traced sets, masked
    steps included; the untraced sets are not counted."""
    assert cg_loop(SETS).traced_products == 1 + 1 * 16
    traced = [{"iterations": 50, "reads": 4, "traced": True}] * 30
    assert cg_loop(SETS[:2] + traced).traced_products == 30 * 65
    assert cg_loop(SETS[:2]).traced_products == 0


def test_cg_launches_per_step_reads_activities_over_products():
    traced = [{"iterations": 50, "reads": 4, "traced": True},
              {"iterations": 3, "reads": 1, "traced": True}]
    trace = window()
    # one activity past the window's end is not counted
    trace.device.append(("merge_tile_kernel", 0.2, 0.3))
    rec = SimpleNamespace(trace=trace, loop=cg_loop(SETS[:2] + traced))
    reader = run.reader("cg_launches_per_step")
    assert reader.read(rec) == pytest.approx(3 / (65 + 17), rel=1e-12)
    assert reader.read(SimpleNamespace(trace=None, loop=rec.loop)) is None
    assert reader.read(SimpleNamespace(trace=trace,
                                       loop=cg_loop(SETS[:2]))) is None
    trace.device = []
    assert reader.read(rec) is None


def test_span_split_takes_each_set_apart():
    from spmv_bench import span_split

    traced = [{"iterations": 50, "reads": 4, "traced": True}] * 2
    rows = span_split.split(window(), SETS[:2] + traced)
    assert [r["host_reads"] for r in rows] == [4, 4]
    assert [r["covered_pct"] for r in rows] == pytest.approx([100, 100])
    first = rows[0]
    assert first["solve_ms"] == pytest.approx(40)
    assert first["idle_ms"] == pytest.approx(40 - 4 - 10)
    assert (first["capture"]["n"], first["replay"]["n"],
            first["flag_read"]["n"]) == (1, 2, 3)
    assert first["capture"]["ms"] == pytest.approx(15)
    assert first["capture"]["idle_ms"] == pytest.approx(15)
    assert first["flag_read"]["idle_ms"] == pytest.approx(2 + 0 + 3)
    assert "capture.enter" not in rows[1]
