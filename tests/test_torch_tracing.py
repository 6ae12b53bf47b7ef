"""The port's spans (merge_spmv_tpu_torch/utils/tracing.py) on the CPU.

Under ``torch.profiler`` (CPU activity) each solver marks one solve span
holding one prologue, an eager block and a flag read per host read, one
release, and no capture when ``graph=False``; ``SpmvOperator`` marks each call.  With
no profiler the spans make no call into the profiler (its
``record_function`` patched to raise) and the results keep their bits.
The capture's spans, its kept pool and its fallback to torch.cuda.graph's
flush, and its place between block 0 and the first flag read, are held
here over stand-ins for torch.cuda's graph and event classes; on the
card, tests/test_torch_cuda.py holds the real capture.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.models import solvers as S
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils import tracing as T

MAXITER, EVERY = 20, 4


def _laplacian(width=8):
    """grid2d's graph Laplacian plus I: symmetric positive definite."""
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(width))
    dense = -csr.to_dense()
    np.fill_diagonal(dense, -dense.sum(axis=1) + 1.0)
    rows, cols = np.nonzero(dense)
    n = dense.shape[0]
    return CsrMatrix.from_coo(CooMatrix(n, n, rows.astype(np.int32),
                                        cols.astype(np.int32),
                                        dense[rows, cols]))


def _stochastic(n=60):
    """A column-stochastic ring with chords, for PageRank."""
    src = np.arange(n, dtype=np.int32).repeat(2)
    dst = np.concatenate([[(i + 1) % n, (3 * i + 2) % n]
                          for i in range(n)]).astype(np.int32)
    return CsrMatrix.from_coo(CooMatrix(n, n, dst, src, np.full(2 * n, 0.5)))


def _solve(kind):
    """(solver call, op(x) calls it makes for its host reads)."""
    if kind == "pagerank":
        op = build_operator(_stochastic(), dtype="float64", device="cpu")
        return (lambda: S.pagerank(op, tol=0.0, maxiter=MAXITER,
                                   check_every=EVERY, graph=False),
                lambda reads: reads * EVERY)
    op = build_operator(_laplacian(), dtype="float64", device="cpu")
    b = np.random.RandomState(0).uniform(-1, 1, op.shape[0])
    solver = {"cg": S.conjugate_gradient, "bicgstab": S.bicgstab}[kind]
    per_step = 2 if kind == "bicgstab" else 1
    return (lambda: solver(op, b, tol=0.0, maxiter=MAXITER,
                           check_every=EVERY, graph=False),
            lambda reads: 1 + per_step * reads * EVERY)


def _spans(prof):
    """(name, start, end) of the profiler's merge_spmv.* events."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("merge_spmv.")]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_every_span_name_is_listed():
    names = {v for k, v in vars(T).items() if k.isupper() and
             isinstance(v, str) and v.startswith("merge_spmv.")}
    assert names == set(T.SPANS)
    assert all(T.SPANS[n] for n in names)


@pytest.mark.parametrize("kind", ["cg", "bicgstab", "pagerank"])
def test_solver_spans_under_the_profiler(kind):
    """One solve holding one prologue and one release; an eager block and
    a flag read per host read; no capture or replay; one op.call per
    host-side op(x)."""
    solve, calls = _solve(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = solve()
    info = out[-1]
    spans = _spans(prof)
    solves = _named(spans, T.SOLVE)
    assert len(solves) == 1
    assert len(_named(spans, T.PROLOGUE)) == 1
    assert info.host_reads == -(-MAXITER // EVERY)
    assert len(_named(spans, T.EAGER_BLOCK)) == info.host_reads
    assert len(_named(spans, T.FLAG_READ)) == info.host_reads
    assert len(_named(spans, T.RELEASE)) == 1
    for name in (T.CAPTURE, T.CAPTURE_ENTER, T.CAPTURE_RECORD,
                 T.CAPTURE_EXIT, T.REPLAY):
        assert not _named(spans, name)
    assert len(_named(spans, T.OP_CALL)) == calls(info.host_reads)
    assert all(_inside(s, solves[0]) for s in spans if s is not solves[0])
    prologue = _named(spans, T.PROLOGUE)[0]
    in_prologue = [s for s in _named(spans, T.OP_CALL)
                   if _inside(s, prologue)]
    assert len(in_prologue) == (0 if kind == "pagerank" else 1)


@pytest.mark.parametrize("kind", ["cg", "bicgstab", "pagerank"])
def test_off_path_makes_no_profiler_call(kind, monkeypatch):
    """With no profiler the spans never reach record_function, and the
    solve returns the bits it returns traced."""
    solve, _ = _solve(kind)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = solve()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = solve()
    assert len(plain) == len(traced)
    for a, b in zip(plain[:-1], traced[:-1]):
        assert torch.equal(a, b)
    assert torch.equal(plain[-1].iterations, traced[-1].iterations)
    assert torch.equal(plain[-1].residual, traced[-1].residual)
    assert plain[-1].host_reads == traced[-1].host_reads


def test_timed_span_stores_seconds_with_and_without_a_profiler():
    times = {}
    with T.span(T.BUILD_PLAN, into=times, key="plan"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span(T.BUILD_PREPARE, into=times, key="prepare"):
            sum(range(1000))
    assert set(times) == {"plan", "prepare"}
    assert all(v >= 0.0 for v in times.values())
    assert [s[0] for s in _spans(prof)] == [T.BUILD_PREPARE]
    assert T.span(T.SOLVE) is T.span(T.REPLAY)      # the shared no-op


def test_timed_span_adds_up_a_phase_timed_twice():
    """A key timed by two spans holds the sum of their seconds
    (pagerank_operator's prepare, before and after its plan)."""
    times = {}
    with T.span(T.BUILD_PREPARE, into=times, key="prepare"):
        sum(range(1000))
    first = times["prepare"]
    with T.span(T.BUILD_PREPARE, into=times, key="prepare"):
        sum(range(1000))
    assert times["prepare"] > first > 0.0
    assert list(times) == ["prepare"]


def test_span_passes_an_exception_on():
    for on in (False, True):
        with pytest.raises(KeyError):
            if on:
                with profile(activities=[ProfilerActivity.CPU]):
                    with T.span(T.SOLVE):
                        raise KeyError("x")
            else:
                with T.span(T.SOLVE):
                    raise KeyError("x")
        times = {}
        with pytest.raises(KeyError):
            with T.span(T.BUILD_PLAN, into=times, key="plan"):
                raise KeyError("x")
        assert times["plan"] >= 0.0


def test_build_operator_times_plan_and_prepare_in_spans():
    """op.setup_s keeps its keys and its 3-decimal seconds; under a
    profiler the two phases are spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op = build_operator(_laplacian(), device="cpu")
    assert list(op.setup_s) == ["plan", "prepare"]
    assert all(v >= 0.0 and round(v, 3) == v for v in op.setup_s.values())
    names = [s[0] for s in _spans(prof)]
    assert names.count(T.BUILD_PLAN) == names.count(T.BUILD_PREPARE) == 1


@pytest.mark.parametrize("method,calls", [("auto", 0), ("column", 3)])
def test_operator_mm_span_holds_its_column_calls(method, calls):
    op = build_operator(_laplacian(), dtype="float64", device="cpu")
    X = torch.ones(op.shape[1], 3, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Y = op.mm(X, method=method)
    spans = _spans(prof)
    mm = _named(spans, T.OP_MM)
    assert len(mm) == 1
    inner = _named(spans, T.OP_CALL)
    assert len(inner) == calls and all(_inside(s, mm[0]) for s in inner)
    assert torch.equal(Y, op.mm(X, method=method))


CUDA = torch.device("cuda")
POOL_ID = (0, 7)
SIDE = object()         # the pool's side stream
BEGIN = ["side stream", ("begin", POOL_ID, "thread_local")]
END = ["end", "back"]


class _Graphs:
    """Stand-ins for torch.cuda's CUDAGraph, graph (the flushing entry)
    and Event, and for the solvers' kept pool, that log what the capture
    calls.  ``busy``: whether an event's query finds the card still
    running the work before it."""

    def __init__(self, monkeypatch, busy=False, refuse_begin=False):
        self.log = []
        log = self.log

        class Graph:
            def capture_begin(self, pool=None, capture_error_mode="global"):
                if refuse_begin:
                    raise RuntimeError("capture_begin refused")
                log.append(("begin", pool, capture_error_mode))

            def capture_end(self):
                log.append("end")

            def replay(self):
                log.append("replay")

        class Capture:
            def __init__(self, graph, capture_error_mode="global"):
                self.graph = graph
                self.mode = capture_error_mode

            def __enter__(self):
                log.append(("flush and begin", self.mode))

            def __exit__(self, *exc):
                log.append(("exit", exc[0]))

        class Event:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

            def query(self):
                return not busy

            def elapsed_time(self, end):
                return 1.0

        class Stream:
            def __init__(self, stream):
                assert stream is SIDE

            def __enter__(self):
                log.append("side stream")

            def __exit__(self, *exc):
                log.append("back")

        self.pool = SimpleNamespace(stream=SIDE, id=POOL_ID,
                                    lock=threading.Lock())
        monkeypatch.setattr(torch.cuda, "stream", Stream)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "graph", Capture)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(S, "_pool", lambda device: self.pool)
        self.Graph = Graph


def _counted(before):
    return {k: S.CAPTURES[k] - before[k] for k in before}


def test_capture_spans_its_entry_recording_and_exit(monkeypatch):
    fake = _Graphs(monkeypatch)
    before = dict(S.CAPTURES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graph, pool = S._capture(lambda: fake.log.append("block"), CUDA)
    assert isinstance(graph, fake.Graph) and pool is fake.pool
    assert pool.lock.locked()          # held until the graph's release
    pool.lock.release()
    assert fake.log == BEGIN + ["block"] + END
    assert _counted(before) == {"pooled": 1, "fresh": 0, "hidden": 0}
    spans = _spans(prof)
    (capture,) = _named(spans, T.CAPTURE)
    parts = [_named(spans, n) for n in (T.CAPTURE_ENTER, T.CAPTURE_RECORD,
                                        T.CAPTURE_EXIT)]
    assert all(len(p) == 1 and _inside(p[0], capture) for p in parts)
    assert parts[0][0][2] <= parts[1][0][1] and \
        parts[1][0][2] <= parts[2][0][1]


@pytest.mark.parametrize("pooled", [True, False])
def test_capture_exits_with_the_error_and_raises_it(monkeypatch, pooled):
    """An error in the recording still ends the capture (capture_end, or
    torch.cuda.graph's exit given the error), is raised, counts no
    capture, and leaves the pool as it found it."""
    fake = _Graphs(monkeypatch)
    if not pooled:
        fake.pool.lock.acquire()       # another solve holds the pool
    before = dict(S.CAPTURES)

    def block():
        raise RuntimeError("op not allowed under capture")

    with pytest.raises(RuntimeError, match="under capture"):
        S._capture(block, CUDA)
    assert fake.log == (BEGIN + END if pooled else
                        [("flush and begin", "thread_local"),
                         ("exit", RuntimeError)])
    assert fake.pool.lock.locked() is not pooled
    assert _counted(before) == {"pooled": 0, "fresh": 0, "hidden": 0}


@pytest.mark.parametrize("busy", [False, True])
def test_capture_falls_back_to_the_flush_while_the_pool_is_held(monkeypatch,
                                                               busy):
    """With the pool held by another solve the capture takes
    torch.cuda.graph's flushing entry, counts as fresh, and leaves the
    pool to its holder; a pooled capture that ends while the card is
    still busy counts as hidden."""
    fake = _Graphs(monkeypatch, busy=busy)
    fake.pool.lock.acquire()
    before = dict(S.CAPTURES)
    graph, pool = S._capture(lambda: fake.log.append("block"), CUDA)
    assert pool is None and fake.pool.lock.locked()
    assert fake.log == [("flush and begin", "thread_local"), "block",
                        ("exit", None)]
    fake.pool.lock.release()
    graph, pool = S._capture(lambda: fake.log.append("block"), CUDA)
    assert pool is fake.pool
    pool.lock.release()
    assert _counted(before) == {"pooled": 1, "fresh": 1,
                                "hidden": 2 if busy else 0}


@pytest.mark.parametrize("maxiter,reads_true,want", [
    # three blocks: block 0, the capture, then a replay a later block
    (12, 9, ["step"] * 4 + BEGIN + ["step"] * 4 + END
     + ["read", "replay", "read", "replay", "read"]),
    # ends in block 0: the graph is recorded and never replayed
    (12, 0, ["step"] * 4 + BEGIN + ["step"] * 4 + END + ["read"]),
    # one block: nothing recorded
    (4, 9, ["step"] * 4 + ["read"]),
])
def test_iterate_records_the_graph_while_block_0_runs(monkeypatch, maxiter,
                                                      reads_true, want):
    """Block 0 is enqueued, then the graph is recorded, then the first
    flag read; the replays follow their reads as before, and the pool is
    free again at the return."""
    fake = _Graphs(monkeypatch)
    reads = []

    def active():
        reads.append(1)
        fake.log.append("read")
        return torch.tensor(len(reads) <= reads_true)

    got = S._iterate(lambda: fake.log.append("step"), active, CUDA,
                     maxiter, 4, graph=True)
    assert fake.log == want
    replays = want.count("replay")
    assert got == (len(reads), 0.25 if replays else None)
    assert not fake.pool.lock.locked()


def test_iterate_frees_the_pool_when_a_read_raises(monkeypatch):
    fake = _Graphs(monkeypatch)

    def active():
        raise RuntimeError("the card was lost")

    with pytest.raises(RuntimeError, match="card was lost"):
        S._iterate(lambda: None, active, CUDA, 8, 4, graph=True)
    assert not fake.pool.lock.locked()


def test_capture_refused_at_its_start_leaves_stream_and_pool(monkeypatch):
    """capture_begin raising: the side stream is left again, the pool
    unlocked, nothing counted, and the error raised."""
    fake = _Graphs(monkeypatch, refuse_begin=True)
    before = dict(S.CAPTURES)
    with pytest.raises(RuntimeError, match="capture_begin refused"):
        S._capture(lambda: fake.log.append("block"), CUDA)
    assert fake.log == ["side stream", "back"]
    assert not fake.pool.lock.locked()
    assert _counted(before) == {"pooled": 0, "fresh": 0, "hidden": 0}
