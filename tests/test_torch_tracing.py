"""The port's spans (merge_spmv_tpu_torch/utils/tracing.py) on the CPU.

Under ``torch.profiler`` (CPU activity) each solver marks one solve span
holding one prologue, an eager block and a flag read per host read, one
release, and no capture when ``graph=False``; ``SpmvOperator`` marks each call.  With
no profiler the spans make no call into the profiler (its
``record_function`` patched to raise) and the results keep their bits.
The capture's spans are held here over a stand-in for torch.cuda's graph
classes; on the card, tests/test_torch_cuda.py holds the real capture.
"""

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


class _Graphs:
    """A stand-in for torch.cuda.CUDAGraph and torch.cuda.graph that logs
    what the capture calls."""

    def __init__(self):
        self.log = []
        log = self.log

        class Graph:
            def replay(self):
                log.append("replay")

        class Capture:
            def __init__(self, graph):
                self.graph = graph

            def __enter__(self):
                log.append("enter")

            def __exit__(self, *exc):
                log.append(("exit", exc[0]))

        self.Graph, self.Capture = Graph, Capture


def test_capture_spans_its_entry_recording_and_exit(monkeypatch):
    fake = _Graphs()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", fake.Graph)
    monkeypatch.setattr(torch.cuda, "graph", fake.Capture)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graph = S._capture(lambda: fake.log.append("block"))
    assert isinstance(graph, fake.Graph)
    assert fake.log == ["enter", "block", ("exit", None)]
    spans = _spans(prof)
    (capture,) = _named(spans, T.CAPTURE)
    parts = [_named(spans, n) for n in (T.CAPTURE_ENTER, T.CAPTURE_RECORD,
                                        T.CAPTURE_EXIT)]
    assert all(len(p) == 1 and _inside(p[0], capture) for p in parts)
    assert parts[0][0][2] <= parts[1][0][1] and \
        parts[1][0][2] <= parts[2][0][1]


def test_capture_exits_with_the_error_and_raises_it(monkeypatch):
    fake = _Graphs()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", fake.Graph)
    monkeypatch.setattr(torch.cuda, "graph", fake.Capture)

    def block():
        raise RuntimeError("op not allowed under capture")

    with pytest.raises(RuntimeError, match="under capture"):
        S._capture(block)
    assert fake.log == ["enter", ("exit", RuntimeError)]
